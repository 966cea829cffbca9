"""Time tile shapes and ablations of the flash forward kernels on the
card: what the long-prefill tiles of `dispatch_tc_d` (bf16) and
`dispatch_f32_d` (f32 past 32 keys) were chosen by, and where their time
goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_flash_tiles
    PYTHONPATH=src python -m repro_torch.launch.profile_flash_tiles --f32 \
        [--parent OLD/src/repro_torch/kernels/flash_attention/csrc/\
flash_attention.cu] [--reps 2] [--variants committed,no_qk]

Builds one library per variant from a copy of
kernels/flash_attention/csrc/flash_attention.cu in which the head dim's
`launch_tc<D, W, BN, QR, MB>` line of `dispatch_tc_d` takes other tiles
(W warps of 16 rows, BN keys a tile, Q in registers or not, MB blocks an
SM), or in which one part of the kernel is cut out
(`no_qk`: no S = Q K^T products; `no_pv`: no O += P V products; `no_exp`:
p = the scaled score, no exponential; the output is then wrong, and only
the time is read). Each variant is checked against the plain version
where it is whole, and timed by CUDA events over back-to-back launches
of the C entry (device time: the host's enqueue is far shorter) at
2048-token causal prefills of the deepseek-moe-16b and smollm-360m heads
and at batch 2, beside SDPA. Prints one JSON line with the card's name
and power limit. Needs the CUDA toolkit and a card.

`--f32` instead times flash_fwd_f32 at `F32_SHAPES`, the f32 LM prefills
past 32 keys (causal, the model layout, FlashParams kind 0): libraries
built the same way from copies of the source and its shared headers
(profile_small_kernels.build_variants), each with a line of
`dispatch_f32_d` (`F32_LINES`: a head dim's, D 128's long and short
groups') taking other tiles (`F32_VARIANTS`: W warps, TR rows a lane
group, so 4 TR rows a warp, BN keys a tile, KS key groups, K and V
loading in turn (SPLIT) or two stages of both, MB blocks an SM) or with
an edit (`F32_EDITS`: the score loop unrolled twice at every head dim;
the cuts `loads_only`, no tile computed, only the copies and the
barriers, `no_qk`, `no_pv`, `no_exp`, where the output is wrong and only
the time is read), and each `--parent` source as it is (an older tree's
flash_attention.cu, that tree's shared headers beside it). Every whole
library is held to the plain version first (max abs error beside each
time). Then, within each repetition, in turns (the order, then its
reverse), each library's device time a call (torch.profiler, with the
library's empty kernel launched after each call in the same window, its
time the launch floor; None where every window lost records) and
CUDA-event us, and SDPA f32 (TF32 off; its kernels by name) as the
yardstick. `--shapes` picks F32_SHAPES by index. Prints one JSON line
with the card's name and power limit.
"""
import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import NVCC_FLAGS, PACKAGE_DIR, _nvcc
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch.profiling import beside_floor, card, kernel_us

SHAPES = [(1, 16, 16, 2048, 128), (1, 15, 5, 2048, 64),
          (2, 16, 16, 2048, 128)]
# name: ({D: (W, BN, QR, MB)} replacing the committed tiles, cuts)
VARIANTS = {
    "committed": ({}, ()),
    "d128_w8": ({128: (8, 64, "true", 1)}, ()),
    "d128_w4_qregs": ({128: (4, 64, "true", 2)}, ()),
    "d128_bn32": ({128: (4, 32, "false", 3)}, ()),
    "d64_w4_bn64": ({64: (4, 64, "true", 4)}, ()),
    "d64_w4_bn128": ({64: (4, 128, "true", 2)}, ()),
    "no_qk": ({}, ("no_qk",)),
    "no_pv": ({}, ("no_pv",)),
    "no_exp": ({}, ("no_exp",)),
}
CUTS = {
    "no_qk": [("      for (int kd = 0; kd < KD; ++kd) {\n        unsigned qa[4];",
               "      for (int kd = 0; kd < 0; ++kd) {\n        unsigned qa[4];")],
    "no_pv": [("      for (int j = 0; j < BN / 16; ++j) {",
               "      for (int j = 0; j < 0; ++j) {")],
    "no_exp": [("const float p0 = ex2(", "const float p0 = ("),
               ("const float p1 = ex2(", "const float p1 = (")],
}


def variant_source(tiles, cuts):
    src = (PACKAGE_DIR / "kernels/flash_attention/csrc/"
           "flash_attention.cu").read_text()
    for D, (w, bn, qr, mb) in tiles.items():
        src, n = re.subn(
            rf"if constexpr \(D == {D}\) return launch_tc<D, [^>]*>",
            f"if constexpr (D == {D}) return launch_tc<D, {w}, {bn}, {qr}, "
            f"{mb}>", src)
        assert n == 1, D
    for cut in cuts:
        for old, new in CUTS[cut]:
            assert old in src, cut
            src = src.replace(old, new)
    return src


def build(tmp):
    """{name: the C entry} of every variant, compiled in parallel."""
    procs = {}
    for name, (tiles, cuts) in VARIANTS.items():
        root = Path(tmp) / name / "kernels"
        (root / "flash_attention/csrc").mkdir(parents=True)
        shutil.copytree(PACKAGE_DIR / "kernels/shared", root / "shared")
        cu = root / "flash_attention/csrc/flash_attention.cu"
        cu.write_text(variant_source(tiles, cuts))
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", str(cu), "-o",
             str(Path(tmp) / name / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-2000:]}")
        fn = ctypes.CDLL(str(Path(tmp) / name / "lib.so")).flash_attention_hsd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fns[name] = fn
    return fns


def event_us(fn, iters=50):
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


# (B, H, KVH, S, D) of the f32 prefills past 32 keys: deepseek-moe-16b at a
# 128-token prompt, paligemma-3b at the default prompt (256 patches + 32
# tokens), smollm-360m at 512 and 2048 tokens, deepseek-moe-16b at 2048
F32_SHAPES = [(4, 16, 16, 128, 128), (4, 8, 1, 288, 256),
              (4, 15, 5, 512, 64), (1, 15, 5, 2048, 64),
              (1, 16, 16, 2048, 128)]
# a line of `dispatch_f32_d` by the tiles it launches: a head dim's, and
# D 128's for groups of at least kLongRows rows and for shorter ones
F32_LINES = {
    **{D: rf"if constexpr \(D == {D}\) return launch_f32<D, [^>]*>"
       for D in (32, 64, 256)},
    "128_long": r"if \(long_rows\) return launch_f32<D, [^>]*>",
    "128_short": r"\n    return launch_f32<D, [^>]*>",
}
# name: ({line of F32_LINES: (W, TR, BN, KS, SPLIT, MB)} replacing the
# committed tiles, edits of F32_EDITS)
F32_VARIANTS = {
    "committed": ({}, ()),
    "d64_tr8_split": ({64: (4, 8, 64, 1, "true", 1)}, ()),
    "d64_tr8_w2": ({64: (2, 8, 64, 1, "false", 2)}, ()),
    "d128_short_bm64": ({"128_short": (4, 4, 32, 2, "true", 1)}, ()),
    "d128_long_tr8": ({"128_long": (4, 8, 32, 1, "true", 1)}, ()),
    "d256_tr4_ks2": ({256: (4, 4, 32, 2, "true", 1)}, ()),
    "d256_tr4": ({256: (4, 4, 32, 1, "true", 1)}, ()),
    "d256_stages": ({256: (4, 2, 32, 1, "false", 1)}, ()),
    "unroll_fixed2": ({}, ("unroll_fixed2",)),
    "loads_only": ({}, ("loads_only",)),
    "no_qk": ({}, ("no_qk",)),
    "no_pv": ({}, ("no_pv",)),
    "no_exp": ({}, ("no_exp",)),
}
_QK_LOOP = ("#pragma unroll (D >= 128 ? 4 : 2)\n"
            "      for (int c = 0; c < C4; ++c) {")
F32_EDITS = {
    # the score loop over d's 16-byte pieces unrolled twice at every head
    # dim (committed: 4 times at D >= 128)
    "unroll_fixed2": [(_QK_LOOP, _QK_LOOP.replace("(D >= 128 ? 4 : 2)",
                                                  "2"))],
    # timing cuts: the output is then wrong
    "loads_only": [("const bool on = warp_on && tk < w_hi && tk + BN > w_lo;",
                    "const bool on = false;")],
    "no_qk": [("      for (int c = 0; c < C4; ++c) {\n        float4 qv[TR]",
               "      for (int c = 0; c < 0; ++c) {\n        float4 qv[TR]")],
    "no_pv": [("for (int j = 0; j < n; j += 4) {",
               "for (int j = 0; j < 0; j += 4) {")],
    "no_exp": [("alpha[i] = expf(m[i] - ref);", "alpha[i] = m[i] - ref;"),
               ("p[i][t] = expf(p[i][t] - ref);", "p[i][t] = p[i][t] - ref;")],
}
F32_CUTS = ("loads_only", "no_qk", "no_pv", "no_exp")


def f32_replacements(source, tiles, edits):
    """The (text, replacement) pairs of an --f32 variant of `source`."""
    reps = []
    for line, (w, tr, bn, ks, split, mb) in tiles.items():
        found = re.findall(F32_LINES[line], source)
        assert len(found) == 1, line
        head = found[0][:found[0].index("launch_f32<")]
        reps.append((found[0], f"{head}launch_f32<D, {w}, {tr}, {bn}, {ks}, "
                               f"{split}, {mb}>"))
    for edit in edits:
        reps += F32_EDITS[edit]
    return reps


def f32_libraries(tmp, names, parents):
    """{library name: its C entry}: the --f32 variants `names` and each
    parent source, every build started at once."""
    from repro_torch.launch.profile_small_kernels import build_variants
    src = PACKAGE_DIR / "kernels/flash_attention/csrc/flash_attention.cu"
    text = src.read_text()
    variants = [(n, f32_replacements(text, *F32_VARIANTS[n])) for n in names
                if n != "committed"]
    libs = build_variants(Path(tmp) / "tree", src, variants)
    if "committed" not in names:
        libs.pop("whole")
    else:
        libs["committed"] = libs.pop("whole")
    for i, parent in enumerate(parents):
        name = "parent" if len(parents) == 1 else f"parent{i}"
        libs[name] = build_variants(Path(tmp) / name, Path(parent),
                                    [])["whole"]
    fns = {}
    for name, dll in libs.items():
        fn = dll.flash_attention_hsd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fns[name] = fn
    return fns


def f32_sweep(tmp, names, parents, reps, shapes=F32_SHAPES):
    """{shape: {library: {max_abs_err, device_us, launch_floor_us,
    events_us}}, "sdpa": ...} of the --f32 sweep."""
    fns = f32_libraries(tmp, names, parents)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for B, H, KVH, S, D in shapes:
        G = H // KVH
        qg, k, v = (torch.randn(shape, generator=gen, device="cuda")
                    for shape in ((B, S, KVH, G, D), (B, S, KVH, D),
                                  (B, S, KVH, D)))
        q = qg.reshape(B, S, H, D).transpose(1, 2)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        ref = attention_ref(q, kh, vh).transpose(1, 2).reshape(qg.shape)
        o = torch.empty_like(qg)
        params = fk.grouped_params(qg, k, v, o, True, 0)
        row = {}
        for name, fn in fns.items():
            o.fill_(float("nan"))
            code = fn(params, stream)
            torch.cuda.synchronize()
            whole = not set(F32_VARIANTS.get(name, ({}, ()))[1]) & set(
                F32_CUTS)
            row[name] = {"launch_code": code, "device_us": [],
                         "launch_floor_us": [], "events_us": [],
                         "max_abs_err": ((o - ref).abs().max().item()
                                         if code == 0 and whole else None)}
        qc, kc, vc = (t.contiguous() for t in (q, kh, vh))

        def sdpa():
            return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                  enable_gqa=True)
        err = (sdpa().transpose(1, 2).reshape(qg.shape) - ref).abs().max()
        row["sdpa"] = {"device_us": [], "events_us": [],
                       "max_abs_err": err.item(),
                       "kernels": list(kernel_us(sdpa, calls=2)[1])}
        live = [n for n in fns if row[n]["launch_code"] == 0]
        iters = 50 if S <= 512 else 10
        for _ in range(reps):
            for name in live + live[::-1] + ["sdpa"]:
                call = sdpa if name == "sdpa" else (
                    lambda fn=fns[name]: fn(params, stream))
                us, floor, _ = beside_floor(call)
                row[name]["device_us"].append(us)
                row[name].setdefault("launch_floor_us", []).append(floor)
                row[name]["events_us"].append(event_us(call, iters))
        out[str((B, H, KVH, S, D))] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.profile_flash_tiles")
    ap.add_argument("--f32", action="store_true",
                    help="time flash_fwd_f32's variants at F32_SHAPES")
    ap.add_argument("--parent", action="append", default=[],
                    help="an older flash_attention.cu to time beside "
                         "(--f32; repeatable)")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--variants", default=",".join(F32_VARIANTS),
                    help="the --f32 variants to build, comma-separated")
    ap.add_argument("--shapes", default=None,
                    help="the --f32 shapes to time, indices of F32_SHAPES, "
                         "comma-separated (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_flash_tiles measures the card; torch "
                           "sees no CUDA device")
    if args.f32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        names = args.variants.split(",")
        unknown = set(names) - set(F32_VARIANTS)
        if unknown:
            raise ValueError(f"unknown --f32 variants {sorted(unknown)}")
        with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
            shapes = F32_SHAPES if args.shapes is None else [
                F32_SHAPES[int(i)] for i in args.shapes.split(",")]
            print(json.dumps({"card": card(), "f32": f32_sweep(
                tmp, names, args.parent, args.reps, shapes)}))
        return
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card(), "us": {}}
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(tmp)
        for B, H, KVH, S, D in SHAPES:
            G = H // KVH
            qg, k, v = (torch.randn(shape, generator=gen,
                                    device="cuda").bfloat16()
                        for shape in ((B, S, KVH, G, D), (B, S, KVH, D),
                                      (B, S, KVH, D)))
            q = qg.reshape(B, S, H, D).transpose(1, 2)
            kh, vh = k.transpose(1, 2), v.transpose(1, 2)
            ref = attention_ref(q, kh, vh).transpose(1, 2).reshape(qg.shape)
            o = torch.empty_like(qg)
            params = fk.grouped_params(qg, k, v, o, True, 0)
            stream = torch.cuda.current_stream().cuda_stream
            row = {}
            for name, fn in fns.items():
                if fn(params, stream) != 0:
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                if not VARIANTS[name][1]:
                    err = (o.float() - ref.float()).abs().max().item()
                    if err > 3e-2:
                        raise RuntimeError(f"{name} {S, D}: error {err}")
                row[name] = event_us(lambda: fn(params, stream))
            qc, kc, vc = (t.contiguous() for t in (q, kh, vh))
            row["sdpa"] = event_us(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True, enable_gqa=True))
            out["us"][str((B, H, KVH, S, D))] = row
    print(json.dumps(out))


if __name__ == "__main__":
    main()
