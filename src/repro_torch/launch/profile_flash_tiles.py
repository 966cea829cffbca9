"""Time tile shapes and ablations of the bf16 tensor-core flash kernel on
the card: what the long-prefill tiles of `dispatch_tc_d` were chosen by,
and where its time goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_flash_tiles

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
"""
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
from repro_torch.launch.profiling import card

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


def main():
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
