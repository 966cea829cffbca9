"""Time the chunked-WKV kernel `wkv6_btHN` on the card at the shapes of
`chip_smoke.py`'s WKV phase, and the column-slice widths its chunked
path can take: what the width `wkv6.cu` picks (`choose_cw`) was chosen
by.

    PYTHONPATH=src python -m repro_torch.launch.profile_wkv [--reps 3]

For each (B, T, H, N, chunk) of `CASES` (`chip_smoke.WKV_CASES`), on f32
inputs with a nonzero u and a carried state: the wrapper's device time
per call (torch.profiler, `launch/profiling.device_window`), the same
with L2 emptied before each call (`device_us_cold_l2`), and its
CUDA-event ms over back-to-back calls. A window in which the profiler
recorded fewer kernels than the calls launched is run again, up to three
times; the device time is None where all three lost records
(`device_ops`: the kernels it saw a call). The same is timed for one library per
width, each built from a copy of kernels/wkv6/csrc/wkv6.cu whose
`choose_cw` returns that width (16, 32, 64 columns a block, where the
shape has that many), and for `cw1`, a copy that takes the streaming
path whatever T and the chunk; each is checked against the plain
version first, and each timing comes with the SM clock nvidia-smi reads
just after. `--reps` repeats the whole sweep, in turns; `--warm S`
keeps the card busy with bf16 matmuls for S seconds before each sweep
(a card that has idled runs short bursts of small kernels at a lower
clock).

`--ablate` instead builds one library per variant from a copy of
wkv6.cu in which one part of the chunked path is cut out (`no_loads`:
no global loads of r, k, logw, v; `no_diag`: no scores within
sub-chunks; `no_cross`: no scores across sub-chunks; `no_y`: no y
products; `no_state`: no state-update products; `no_scan`: no cumsum;
`no_sync`: no barrier inside the chunk loop; `skeleton`: the first five
at once; the output is then wrong, and only the time is read) and times
each against the whole kernel by CUDA events over back-to-back launches
of its C entry, at the rwkv6-1.6b prefill and 512-token shapes and a
ragged N = 8 case, each at the slice width the kernel picks there.
Prints one JSON line with the card's name and power limit. Needs a card
and the CUDA toolkit.
"""
import argparse
import ctypes
import json
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.kernels.common import (NVCC_FLAGS, PACKAGE_DIR, _nvcc,
                                        launch_stream)
from repro_torch.kernels.wkv6 import kernel as wk
from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.launch.profiling import card, device_window

# chip_smoke.WKV_CASES: the rwkv6-1.6b serve prefill, a 512-token prompt,
# the decode step, the reference's sweep shapes
CASES = [(4, 32, 32, 64, 64), (4, 512, 32, 64, 64), (4, 1, 32, 64, 1),
         (2, 100, 3, 16, 32), (1, 37, 1, 8, 16)]
TOL = dict(atol=2e-4, rtol=1e-3)
ABLATE_CASES = [(4, 32, 32, 64, 64), (4, 512, 32, 64, 64), (1, 37, 1, 8, 16)]
# variant: [(text in wkv6.cu, its replacement)]
CUTS = {
    "whole": [],
    "no_loads": [("if (t < Lc && n < kNP) {", "if (false) {"),
                 ("vv[i] = t < Lc ?", "vv[i] = false ?")],
    "no_diag": [("for (int it = kT - 1 - tid; it < NS * kPairs; it += kT) {",
                 "for (int it = kT - 1 - tid; it < 0; it += kT) {")],
    "no_cross": [("if (NS > 1) {", "if (false) {")],
    "no_y": [("for (int jq = part; jq <= tq; jq += parts) {",
              "for (int jq = part; jq < 0; jq += parts) {"),
             ("for (int nq = part; nq < kNQ; nq += parts) {\n"
              "          float4 a[4], sb[4];",
              "for (int nq = part; nq < 0; nq += parts) {\n"
              "          float4 a[4], sb[4];")],
    "no_state": [("for (int jl = s_part; jl < 4; jl += C::kSParts) {",
                  "for (int jl = s_part; jl < 0; jl += C::kSParts) {")],
    "no_scan": [("for (int off = 1; off < kSub; off <<= 1) {",
                 "for (int off = 1; off < 1; off <<= 1) {")],
    "no_sync": [("__syncthreads();  // the previous chunk is done with every "
                 "buffer", ""),
                ("__syncthreads();  // phase 1 is written", ""),
                ("__syncthreads();  // every score is written", "")],
}
# every cut at once: the chunked path's skeleton
CUTS["skeleton"] = [c for name in ("no_loads", "no_diag", "no_cross", "no_y",
                                   "no_state") for c in CUTS[name]]
# a library per slice width: `choose_cw` returns that width, or (cw1) the
# streaming path is taken whatever T and the chunk
_CHOICE = "const int cw = BH >= 64 ? 64 : BH >= 32 ? 32 : 16;"
WIDTHS = {f"cw{w}": [(_CHOICE, f"const int cw = {w};")] for w in (16, 32, 64)}
WIDTHS["cw1"] = [("if (p.T < kSub || p.L < kSub) {", "if (true) {")]


def inputs(B, T, H, N, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    logw = -torch.exp(0.5 * randn(B, T, H, N))
    return (randn(B, T, H, N), randn(B, T, H, N), randn(B, T, H, N), logw,
            0.3 + 0.2 * randn(H, N), 0.2 * randn(B, H, N, N))


def events_ms(fn, iters):
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sm_clock_mhz():
    """The card's SM clock now, as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0])


def warm(seconds):
    """Keep the card busy with bf16 matmuls for `seconds`, so that the
    timings after it run at the clock a loaded card holds."""
    if seconds <= 0:
        return
    a = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()


def window(fn, kernels, n=10, tries=3):
    """`device_window` of n calls of `fn`, which launches `kernels`
    kernels a call; a window in which the profiler saw fewer lost
    records and is run again, up to `tries` windows. Returns the last
    window and whether it was whole."""
    for _ in range(tries):
        prof = device_window(fn, n)
        if prof["records_whole"] and prof["device_ops_per_call"] >= kernels:
            return prof, True
    return prof, False


def device_us(fn):
    """`fn`'s device time per call in us (None where every window lost
    records), and the kernels the profiler saw a call."""
    prof, whole = window(fn, 1)
    return (prof["device_ms_per_call"] * 1e3 if whole else None,
            prof["device_ops_per_call"])


def timed(fn, iters):
    us, ops = device_us(fn)
    out = {"device_us": us, "device_ops": ops, "ms": events_ms(fn, iters)}
    out["sm_clock_mhz"] = sm_clock_mhz()  # just after the timed calls
    return out


def cold_device_us(fn):
    """The WKV kernel's device time per call with L2 cold: a 64 MB
    buffer is written before each call (the serve path finds the state,
    48 MB over the layers, and much of its inputs outside the 50 MB L2;
    back-to-back calls find them in it). None where the profiler lost
    records."""
    flush = torch.empty(16 * 2 ** 20, device="cuda")
    prof, whole = window(lambda: (flush.zero_(), fn()), 2)
    if not whole:
        return None
    return sum(k["us"] for k in prof["top_device_us_per_call"]
               if "wkv6" in k["name"])


def widths(N, T, L):
    """The width libraries that apply at N, T and the chunk: the slice
    widths up to N's padded width, and cw1 (none where T or the chunk is
    below 16: every library takes the streaming path there)."""
    if T < 16 or L < 16:
        return []
    np_ = 16 if N <= 16 else 32 if N <= 32 else 64
    return [f"cw{w}" for w in (16, 32, 64) if w <= np_] + ["cw1"]


def entry(fn, r, k, v, logw, u, state, L):
    """One library's C entry on the state it is given; returns (y,
    state)."""
    B, T, H, N = r.shape
    y = torch.empty_like(r)
    params = wk.PARAMS.pack(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), state.data_ptr(), y.data_ptr(), state.data_ptr(),
        B, T, H, N, L, 0)
    if fn(params, launch_stream(r.device)) != 0:
        raise RuntimeError("wkv6_btHN: launch failed")
    return y, state


def within_tol(pairs):
    return all(bool(((a - b).abs() <= TOL["atol"] + TOL["rtol"]
                     * b.abs()).all()) for a, b in pairs)


def sweep(libs):
    out = {}
    for B, T, H, N, L in CASES:
        r, k, v, logw, u, s0 = inputs(B, T, H, N)
        state = s0.clone()
        iters = 200 if T <= 64 else 50
        def wrapper():
            return wk.wkv6_btHN(r, k, v, logw, u, state, chunk=L)
        row = {"wrapper": timed(wrapper, iters)}
        row["wrapper"]["device_us_cold_l2"] = cold_device_us(wrapper)
        ry, rS = wkv6_ref(r, k, v, logw, u, s0)
        for name in widths(N, T, L):
            fn = libs[name]
            y, S = entry(fn, r, k, v, logw, u, s0.clone(), L)
            torch.cuda.synchronize()
            row[name] = dict(timed(lambda: entry(
                fn, r, k, v, logw, u, state, L), iters),
                within_tol=within_tol(((y, ry), (S, rS))))
        out[str((B, T, H, N, L))] = row
    return out


def build_variants(tmp, variants):
    """{variant: its C entry}, each compiled from a copy of wkv6.cu with
    its replacements made (every build started at once)."""
    csrc = PACKAGE_DIR / "kernels" / "wkv6" / "csrc"
    src = (csrc / "wkv6.cu").read_text()
    procs = {}
    for name, cuts in variants.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in wkv6.cu once")
            text = text.replace(old, new)
        cu = Path(tmp) / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(  # -I: its includes resolve
            [_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-shared", str(cu), "-o",
             str(Path(tmp) / f"{name}.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(Path(tmp) / f"{name}.so")).wkv6_btHN
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def ablate(tmp):
    out = {}
    fns = build_variants(tmp, CUTS)
    for B, T, H, N, L in ABLATE_CASES:
        r, k, v, logw, u, s0 = inputs(B, T, H, N)
        ry, rS = wkv6_ref(r, k, v, logw, u, s0)
        stream = launch_stream(r.device)
        row = {}
        for name, fn in fns.items():
            y, S = torch.empty_like(r), s0.clone()
            params = wk.PARAMS.pack(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                u.data_ptr(), S.data_ptr(), y.data_ptr(), S.data_ptr(),
                B, T, H, N, L, 0)
            if fn(params, stream) != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            row[name] = {}
            if name == "whole":  # before the timed calls advance S
                row[name]["within_tol"] = within_tol(((y, ry), (S, rS)))
            row[name]["ms"] = events_ms(lambda: fn(params, stream),
                                        50 if T > 64 else 200)
        out[str((B, T, H, N, L))] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.profile_wkv")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--warm", type=float, default=0.0,
                    help="seconds of bf16 matmuls before each sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_wkv measures the card; torch sees no "
                           "CUDA device")
    with torch.no_grad(), tempfile.TemporaryDirectory() as tmp:
        if args.ablate:
            print(json.dumps({"card": card(), "ablate": ablate(tmp)}))
            return
        libs = build_variants(tmp, WIDTHS)
        reps = []
        for _ in range(args.reps):
            warm(args.warm)
            reps.append(sweep(libs))
    print(json.dumps({"card": card(), "reps": reps}))


if __name__ == "__main__":
    main()
