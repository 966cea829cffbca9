"""Time the float32 grouped matmul `gmm_f32_kernel` (kernels/gmm/csrc/
gmm.cu) on the card: its tile variants, two timing cuts and an older
tree's source, beside `torch.bmm` f32, in turns, at the f32 serve path's
expert shapes.

    PYTHONPATH=src python -m repro_torch.launch.profile_gmm_f32 \
        [--parent OLD/src/repro_torch/kernels/gmm/csrc/gmm.cu] [--reps 2] \
        [--variants committed,loads_only] [--shapes 0,2,4]

`SHAPES` are deepseek-moe-16b's (E, C, d, f) at batch 4: decode (C = 8),
prefill at the launcher's default prompt of 32 (C = 15) and at a
128-token prompt (C = 60), then at batch 1 at 2048- and 4096-token
prompts (C = 202 and 480; the benchmark's prompts run 512 to 4096, C =
60 to 480), each for wi/wg (d 2048, f 1408) and wo (d 1408, f 2048). A
library whose `gmm_ecd` takes each expert's count of rows that hold
input is timed twice: without the counts, and as `<name>+rows` with
counts drawn as a skewed routing leaves them (`routed_rows`: E C / 1.25
assignments over gamma(4) shares, one expert 8% more; ~68% of the rows
routed, ~15% of the assignments past C, as the benchmark's deepseek cell
reads them), the bound then of the routed rows. One library is built
per variant from a copy of gmm.cu
and the shared headers (profile_small_kernels.build_variants, every
build started at once): `committed` is the source as it is; a tile
variant replaces the `launch_f32<BM, BN, BK, TM, TN, STAGES, MINB>`
line of `dispatch_f32` for one range of C (`LINES`: C <= 8, 16, 32, and
the rest); an edit (`EDITS`) cuts a part out, and the output is then
wrong and only the time is read: `loads_only` (the copies into the ring
and its barriers, no FMA: the w stream alone) and `fma_only` (no copy:
the FMAs and shared-memory reads alone, on whatever the ring holds).
Each `--parent` source is built as it is (that tree's shared headers
beside it). Every whole library is held to the plain version first (max
abs error, and whether two calls are bitwise equal). Then, within each
repetition, in turns (the order, then its reverse), each library's
device time a call (torch.profiler, `profiling.kernel_us`; None where
every window lost records) and CUDA-event us, and `torch.bmm` f32 (TF32
off) as the yardstick, its kernels by name. Each shape carries its bound
(the larger of the bytes at 3.35 TB/s and the FMAs at 67 TFLOP/s). Prints
one JSON line with the card's name and power limit. Needs the CUDA
toolkit and a card.
"""
import argparse
import ctypes
import json
import re
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels.common import PACKAGE_DIR
from repro_torch.kernels.gmm.ref import gmm_ref
from repro_torch.launch.profile_flash_tiles import event_us
from repro_torch.launch.profiling import card, kernel_us

SOURCE = PACKAGE_DIR / "kernels" / "gmm" / "csrc" / "gmm.cu"
SHAPES = [(64, 8, 2048, 1408), (64, 8, 1408, 2048), (64, 15, 2048, 1408),
          (64, 15, 1408, 2048), (64, 60, 2048, 1408), (64, 60, 1408, 2048),
          (64, 202, 2048, 1408), (64, 202, 1408, 2048), (64, 480, 2048, 1408),
          (64, 480, 1408, 2048)]
BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# a line of `dispatch_f32` by the row tile (the range of C) it launches
LINES = {
    **{n: rf"case {n}:\n      return launch_f32<[^>]*>" for n in (8, 16, 32)},
    64: r"default:\n      return launch_f32<[^>]*>",
}
# name: ({line of LINES: (BM, BN, BK, TM, TN, STAGES, MINB)} replacing the
# committed tiles, edits of EDITS)
VARIANTS = {
    "committed": ({}, ()),
    "c8_s4": ({8: (8, 128, 16, 4, 4, 4, 6)}, ()),
    "c8_bn256": ({8: (8, 256, 16, 8, 4, 3, 4)}, ()),
    "c16_s4": ({16: (16, 128, 16, 8, 4, 4, 6)}, ()),
    "c16_bk8": ({16: (16, 128, 8, 8, 4, 6, 8)}, ()),
    "c16_bn256": ({16: (16, 256, 16, 8, 4, 3, 4)}, ()),
    "c64_bk16": ({64: (64, 128, 16, 8, 8, 4, 3)}, ()),
    "c64_m3": ({64: (64, 128, 32, 8, 8, 3, 3)}, ()),
    "c64_s4": ({64: (64, 128, 32, 8, 8, 4, 2)}, ()),
    "c64_bk24": ({64: (64, 128, 24, 8, 8, 3, 3)}, ()),
    "c64_tm16": ({64: (64, 128, 32, 16, 4, 3, 3)}, ()),
    "c64_tm16_m2": ({64: (64, 128, 32, 16, 4, 3, 2)}, ()),
    "c64_bn64": ({64: (64, 64, 32, 4, 8, 3, 4)}, ()),
    "c64_tm4": ({64: (64, 128, 32, 4, 8, 3, 2)}, ()),
    "c64_bn64_tm8": ({64: (64, 64, 16, 8, 8, 4, 6)}, ()),
    "c64_bn64_tm8_bk32": ({64: (64, 64, 32, 8, 8, 3, 4)}, ()),
    "c60_tm5": ({64: (60, 128, 32, 5, 8, 3, 2)}, ()),
    "c60_tm5_m3": ({64: (60, 128, 32, 5, 8, 3, 3)}, ()),
    "unroll2": ({}, ("unroll2",)),
    "group_skip": ({}, ("group_skip",)),
    "loads_only": ({}, ("loads_only",)),
    "fma_only": ({}, ("fma_only",)),
}
_KK = "#pragma unroll\n    for (int kk = 0; kk < BK; kk += 4) {"
EDITS = {
    # the k loop over a stage unrolled twice (committed: whole)
    "unroll2": [(_KK, _KK.replace("unroll", "unroll 2"))],
    # a thread's row group i (rows i TY .. i TY + TY - 1 of the tile) skips
    # its FMAs where every row of it lies past the count: a branch uniform
    # over the block
    "group_skip": [("      for (int i = 0; i < TM; ++i)\n"
                    "        fma_row<NG>(",
                    "      for (int i = 0; i < TM; ++i)\n"
                    "        if (i * TY < live) fma_row<NG>(")],
    "loads_only": [("    for (int kk = 0; kk < BK; kk += 4) {\n"
                    "      float4 wv[4][NG];",
                    "    for (int kk = 0; kk < 0; kk += 4) {\n"
                    "      float4 wv[4][NG];")],
    "fma_only": [("  for (int s = 0; s < STAGES - 1; ++s) {\n"
                  "    if (s < ktiles) load(s, s);",
                  "  for (int s = 0; s < STAGES - 1; ++s) {\n    ;"),
                 ("    if (kt + STAGES - 1 < ktiles)\n"
                  "      load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);",
                  "    ;")],
}
CUTS = ("loads_only", "fma_only")


def replacements(source, tiles, edits):
    """The (text, replacement) pairs of a variant of `source`."""
    reps = []
    for line, tile in tiles.items():
        found = re.findall(LINES[line], source)
        assert len(found) == 1, line
        head = found[0][:found[0].index("launch_f32<")]
        args = ", ".join(map(str, tile))
        reps.append((found[0], f"{head}launch_f32<{args}>"))
    for edit in edits:
        reps += EDITS[edit]
    return reps


def libraries(tmp, names, parents):
    """{library name: (its C entry `gmm_ecd`, whether that takes counts of
    rows)}: the variants `names` and each parent source, every build
    started at once."""
    from repro_torch.launch.profile_small_kernels import build_variants
    text = SOURCE.read_text()
    variants = [(n, replacements(text, *VARIANTS[n])) for n in names
                if n != "committed"]
    libs = build_variants(Path(tmp) / "tree", SOURCE, variants)
    whole = libs.pop("whole")
    if "committed" in names:
        libs = {"committed": whole, **libs}
    for i, parent in enumerate(parents):
        name = "parent" if len(parents) == 1 else f"parent{i}"
        libs[name] = build_variants(Path(tmp) / name, Path(parent),
                                    [])["whole"]
    fns = {}
    for name, dll in libs.items():
        takes_rows = hasattr(dll, "gmm_ecd_row_tile")
        fn = dll.gmm_ecd
        fn.argtypes = [ctypes.c_void_p] * (4 if takes_rows else 3) + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = (fn, takes_rows)
    return fns


def routed_rows(E, C, seed=0):
    """(E,) int64 counts of rows a skewed routing gives each expert at
    capacity C: round(E C / 1.25) assignments over gamma(4) shares, 8% more
    to expert 0; counts past C stay (the kernel clamps them)."""
    g = torch.Generator().manual_seed(seed)
    p = torch._standard_gamma(torch.full((E,), 4.0, dtype=torch.float64),
                              generator=g)
    p = p / p.sum() * 0.92
    p[0] += 0.08
    n = round(E * C / 1.25)
    return torch.multinomial(p, n, replacement=True, generator=g).bincount(
        minlength=E)


def bound_us(E, C, d, f, routed=None):
    """(the least time the card could take, in us, and what bounds it):
    each f32 input read once and the output written once at 3.35 TB/s,
    against 2 E C d f flops at 67 TFLOP/s; with `routed` (the rows that
    hold input, in all), only those rows' x and flops count."""
    rows = E * C if routed is None else routed
    t_bytes = 4 * (rows * d + E * d * f + E * C * f) / BYTES_PER_S * 1e6
    t_ops = 2 * rows * d * f / F32_FLOPS * 1e6
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sweep(tmp, names, parents, reps, shapes=SHAPES):
    """{shape: {library: {max_abs_err, bitwise_repeat, device_us: [...],
    events_us: [...]}, "bmm": ..., "bound_us", "bound_by"}}."""
    fns = libraries(tmp, names, parents)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for E, C, d, f in shapes:
        x = torch.randn((E, C, d), generator=gen, device="cuda")
        w = torch.randn((E, d, f), generator=gen, device="cuda") * d ** -0.5
        rows = routed_rows(E, C).cuda()
        refs = {False: gmm_ref(x, w), True: gmm_ref(x, w, rows)}
        o = torch.empty((E, C, f), device="cuda")
        bound, by = bound_us(E, C, d, f)
        routed = int(rows.clamp_max(C).sum())
        row = {"bound_us": bound, "bound_by": by,
               "max_abs_ref": refs[False].abs().max().item(),
               "rows": rows.tolist(), "routed_share": routed / (E * C),
               "bound_rows_us": bound_us(E, C, d, f, routed)[0]}
        calls = {}
        for lib, (fn, takes_rows) in fns.items():
            for counted in (False, True) if takes_rows else (False,):
                name = lib + ("+rows" if counted else "")
                args = (x.data_ptr(), w.data_ptr(), o.data_ptr()) + (
                    ((rows.data_ptr() if counted else None),)
                    if takes_rows else ())

                def call(fn=fn, args=args):
                    return fn(*args, 0, E, C, d, f, stream)
                ref = refs[counted]
                o.fill_(float("nan"))
                code = call()
                torch.cuda.synchronize()
                whole = not set(VARIANTS.get(lib, ({}, ()))[1]) & set(CUTS)
                first = o.clone()
                call()
                torch.cuda.synchronize()
                row[name] = {
                    "launch_code": code, "device_us": [], "events_us": [],
                    "max_abs_err": ((first - ref).abs().max().item()
                                    if code == 0 and whole else None),
                    "bitwise_repeat": (torch.equal(first, o)
                                       if code == 0 and whole else None)}
                if code == 0:
                    calls[name] = call
        ref = refs[False]

        def bmm():
            return torch.bmm(x, w)
        row["bmm"] = {"device_us": [], "events_us": [],
                      "max_abs_err": (bmm() - ref).abs().max().item(),
                      "kernels": list(kernel_us(bmm, calls=2)[1])}
        calls["bmm"] = bmm
        order = list(calls)
        for _ in range(reps):
            for name in order + order[::-1]:
                times, _ = kernel_us(calls[name])
                row[name]["device_us"].append(
                    None if times is None else sum(times.values()))
                row[name]["events_us"].append(event_us(calls[name], 20))
        out[str((E, C, d, f))] = row
        del x, w, ref, refs, o
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.profile_gmm_f32")
    ap.add_argument("--parent", action="append", default=[],
                    help="an older gmm.cu to time beside (repeatable)")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="the variants to build, comma-separated")
    ap.add_argument("--shapes", default=None,
                    help="the shapes to time, indices of SHAPES, "
                         "comma-separated (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_gmm_f32 measures the card; torch sees "
                           "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}")
    shapes = SHAPES if args.shapes is None else [
        SHAPES[int(i)] for i in args.shapes.split(",")]
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        print(json.dumps({"card": card(), "gmm_f32": sweep(
            tmp, names, args.parent, args.reps, shapes)}))


if __name__ == "__main__":
    main()
