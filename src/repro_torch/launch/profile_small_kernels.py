"""Device time of the port's small kernels beside the launch floor, on the
card: the f32 flash-attention forward at the policy trunk's serving
shapes, its training forward (with each row's log-sum-exp) and its
backward at the trunk's training shapes, the discounted-return scan and
its adjoint, and V-trace.

    PYTHONPATH=src python -m repro_torch.launch.profile_small_kernels \
        [--reps 2] [--ablate]
    PYTHONPATH=src python -m repro_torch.launch.profile_small_kernels \
        --bwd [--bwd-parent OLD/src/repro_torch/kernels/flash_attention/\
csrc/flash_attention_bwd.cu] [--reps 2]

The sweep: f32 flash attention through the model's entry
(`ops.flash_attention`) at the trunk's serve buckets (B = 1, 4, 8, 16,
32; H = 4 over KVH = 2, D = 64, causal; S = 4 for cartpole and 3 for
pendulum) and `chip_smoke.KERNEL_CASES`' f32 rows;
`flash_attention_fwd_lse`, `flash_attention_hsd` (the same forward
without lse) and `flash_attention_bwd` at the trunk's training shapes (`TRAIN`: H = 4 over KVH = 2, S = 4 (cartpole) and 3
(pendulum), D = 32 (the reduced trunk, rl_train's default) and 64 (full
width), B = the learner's batches: 64 (dqn), 256 (a ppo minibatch) and
1024 (a3c and impala at 32 envs x 32 steps)); and the scans
(`discounted_return_tb`, `discounted_return_adjoint_tb` with every
gradient) and `vtrace_tb` at `chip_smoke.SCAN_SHAPES` and the adjoint
with dinit alone (A3C's call) at (32, 32). For each: the kernels' device time per call
(torch.profiler, `profiling.kernel_us`) with the library's empty kernel
(kernels/shared/csrc/null.cu) launched after each call in the same
window, its device time the launch floor; and CUDA-event ms over
back-to-back calls. `--reps` repeats the sweep, in turns.

`--ablate` instead builds one library per variant from a copy of a
kernel source and of the shared headers it includes
(kernels/shared/csrc/*.cuh) in which one part is cut out (the output is
then wrong, and only the time is read), loads it in place of the built
library behind the wrappers, and reads each variant's device time per
call at the trunk's serving shape (32, 4, 2, 4, 64) and the f32 LM
prefill shapes of `KERNEL_CASES`, and the scans' and V-trace's
`SCAN_SHAPES`. The cuts: for the
short-span f32 flash kernels (`flash_short_reg_f32`, `flash_short_f32`)
`no_staging` (no global loads), `no_scores`, `no_softmax` (no max, exp
or sum), `no_pv`, `no_store` (outputs computed, not written); for the
scans `no_loads`, `no_chain` (each step's output no longer depends on
the next: the lanes' rows and the shuffle tree) and `no_store`;
for V-trace (`vtrace_short`, `vtrace_tiled`) `no_loads`, `no_prologue`
(no e^{log rho}, clips or delta), `no_chain`, `no_epilogue` (pg_adv
not formed) and `no_store`; `skeleton`, those cuts at once. Beside them: `launch` (the grid returns
at once: its launch and block scheduling), `loads_only` (it returns once
the tiles are in shared memory), and design alternatives measured
whole: `tiled_t32` (T <= 32 on the tiled scans, K = 4, in place of the
short kernels). Prints
one JSON line with the card's name and power limit. Needs a card and the
CUDA toolkit.

`--bwd` instead times the flash backward (`flash_attention_bwd`) at
`TRAIN` and `BWD_EXTRA` (5 keys, one past phase 1's 4 at a time; 8
keys; and operands one float off their alignment) in libraries built the
same way: the source as it is (`whole`), its design alternatives
measured whole (`_FLASH_BWD`: 1, 2 or 8 groups a block at most
instead of 4; rounds of 4 rows instead of 8; rows unpadded in shared
memory; phase 1's keys unrolled by 2; registers not capped at 128 at
D <= 64; the scalar-copy
instance everywhere; and, timing only, the output then
wrong, the kernel cut once a round's copies have landed, `to_loads`, and
after phase 1, `to_phase1`), and each `--bwd-parent` source as it
is (an older tree's flash_attention_bwd.cu, with that tree's shared
headers beside it), in turns within each repetition (the order, then
its reverse). Each library's gradients are held to `attention_bwd_ref`
first (max abs error beside each time).
"""
import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import common
from repro_torch.kernels.advantages import kernel as scan_kernel
from repro_torch.kernels.advantages.ref import discounted_return_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.vtrace import kernel as vtrace_kernel
from repro_torch.launch.profiling import beside_floor, card

# (B, H, KVH, S, D, causal, window): the trunk's serve buckets, then
# chip_smoke.KERNEL_CASES (its f32 rows)
TRUNK = [(b, 4, 2, s, 64, True, 0) for s in (4, 3) for b in (1, 4, 8, 16,
                                                              32)]
KERNEL_CASES = [(32, 4, 2, 4, 64, True, 0), (4, 16, 16, 32, 128, True, 0),
                (4, 15, 5, 32, 64, True, 0), (2, 4, 2, 384, 64, True, 0),
                (1, 4, 1, 256, 64, True, 64), (2, 2, 2, 96, 32, False, 0),
                (1, 2, 1, 512, 256, True, 0), (4, 16, 16, 128, 128, True, 0)]
SCAN_SHAPES = [(32, 32), (32, 4096), (2048, 128)]
SERVE = (32, 4, 2, 4, 64, True, 0)
# (B, H, KVH, S, D) of the trunk's training calls
TRAIN = [(b, 4, 2, 4, d) for d in (32, 64) for b in (64, 256, 1024)] + \
    [(256, 4, 2, 3, 64)]
# (B, H, KVH, S, D, float offset) beside TRAIN for the backward's
# variants: one key past the trunk's 4, which phase 1 takes 4 at a time
# at D 64, 8 keys, and the path's shape with every
# operand one float off its 16-byte alignment (the scalar-copy instance)
BWD_EXTRA = [(256, 4, 2, 5, 64, 0), (256, 4, 2, 8, 64, 0),
             (256, 4, 2, 4, 64, 1)]
ABLATE_FLASH = [SERVE, (4, 16, 16, 32, 128, True, 0),
                (4, 15, 5, 32, 64, True, 0)]
ABLATE_SCANS = SCAN_SHAPES

# [(variant, [(text, its replacement)])] by kernel source; every text
# stands in the source (build_variants raises otherwise)
_FLASH_SHORT = [  # flash_short_f32 and flash_short_reg_f32, both cut
    ("no_staging", [("for (int lr = tid / C4; lr < R; lr += kStep) {",
                     "for (int lr = tid / C4; lr < 0; lr += kStep) {"),
                    ("for (int row = tid / C4; row < ngb * n; row += kStep) {",
                     "for (int row = tid / C4; row < 0; row += kStep) {"),
                    ("      qv[e][i] = load4(qrow + 4 * (p + P * i), vec);\n"
                     "      kv[e][i] = load4(kb + jc * a.k_s + 4 * (p + P * i), "
                     "vec);",
                     "      qv[e][i] = make_float4(1.f, 1.f, 1.f, 1.f);\n"
                     "      kv[e][i] = qv[e][i];"),
                    ("vv[e][jj][i] = sm90::ld_nc(vb + min(jj, n - 1) * "
                     "a.v_s + 32 * i);", "vv[e][jj][i] = float(i);")]),
    ("no_scores", [("for (int i = 0; i < C4; ++i) {\n      const float4 qv",
                    "for (int i = 0; i < 0; ++i) {\n      const float4 qv"),
                   ("for (int i = 0; i < kQ; ++i) {\n      s = fmaf",
                    "for (int i = 0; i < 0; ++i) {\n      s = fmaf")]),
    ("no_softmax", [("const float mx = warp_max(valid ? s : -INFINITY);\n"
                     "    pr[e] = valid ? expf(s - mx) : 0.f;\n"
                     "    l[e] = warp_sum(pr[e]);",
                     "const float mx = 0.f;\n    pr[e] = valid ? s : 0.f;"
                     "\n    l[e] = pr[e];"),
                    ("#pragma unroll\n    for (int m = 16; m >= P; m >>= 1)"
                     "\n      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, m));"
                     "\n    const float pr = valid ? expf(s - mx) : 0.f;",
                     "const float pr = valid ? s : 0.f;"),
                    ("#pragma unroll\n    for (int m = 16; m >= P; m >>= 1) "
                     "l += __shfl_xor_sync(kFull, l, m);", "")]),
    ("no_pv", [("for (int jj = 0; jj < n; ++jj) {",
                "for (int jj = 0; jj < 0; ++jj) {"),
               ("for (int jj = 0; jj < NP; ++jj) {\n      const float pj",
                "for (int jj = 0; jj < 0; ++jj) {\n      const float pj")]),
    ("no_store", [("for (int i = 0; i < kPer; ++i) orow[32 * i] = "
                   "acc[e][i] * inv;",
                   "for (int i = 0; i < kPer; ++i) if (inv == -1.f) "
                   "orow[32 * i] = acc[e][i];"),
                  ("for (int i = 0; i < kPer; ++i) orow[32 * i] = acc[i] * inv;",
                   "for (int i = 0; i < kPer; ++i) if (inv == -1.f) "
                   "orow[32 * i] = acc[i];")]),
]
# the tiled kernels' loads and stores (shared/csrc/scan_tiles.cuh)
_LOAD_TILE = ("if (q >= Tl::kQuads || t < 0 || t >= T) continue;",
              "if (true) continue;")
_STORE_OUT = ("for (int q = threadIdx.x; q < n * Tl::kRowQuads; "
              "q += kThreads) {",
              "for (int q = threadIdx.x; q < 0; q += kThreads) {")
_SCAN = [  # the parallel scans of advantages.cu, forward and adjoint
    ("no_loads", [_LOAD_TILE,
                  ("    bv[i] = ld_nc(base.p + t * base.s0 + bc * base.s1);\n"
                   "    cv[i] = ld_nc(coef.p + t * coef.s0 + bc * coef.s1);",
                   "    bv[i] = float(i);\n    cv[i] = 0.5f;"),
                  ("    gv[i] = ld_nc(g.p + tc * g.s0 + bc * g.s1);\n"
                   "    cv[i] = ld_nc(coef.p + max(tc - 1, 0) * coef.s0 + "
                   "bc * coef.s1);\n"
                   "    if (need_o) ov[i] = ld_nc(out.p + min(tc + 1, T - 1) "
                   "* out.s0 +\n                              bc * out.s1);",
                   "    gv[i] = float(i);\n    cv[i] = 0.5f;\n    ov[i] = 1.f;")]),
    ("no_chain", [("for (int d = 1; d < 32; d <<= 1) {",
                   "for (int d = 1; d < 1; d <<= 1) {"),
                  ("x = fmaf(sC[u][lane], x, sB[u][lane]);", ""),
                  ("Bv = fmaf(cv[i], Bv, bv[i]);", "Bv = bv[i];"),
                  ("Bv = fmaf(cv[i], Bv, gv[i]);", "Bv = gv[i];"),
                  ("x = fmaf(cv[i], x, bv[i]);", "x = bv[i];"),
                  ("x = fmaf(cv[i], x, gv[i]);", "x = gv[i];"),
                  ("for (int s = K - 1; s >= 0; --s) {",
                   "for (int s = K - 1; s >= K; --s) {"),
                  ("for (int s = 0; s < K; ++s) {",
                   "for (int s = 0; s < 0; ++s) {")]),
    ("no_store", [_STORE_OUT,
                  ("      out[int64_t(t) * B + b] = x;",
                   "      if (x == -1.f) out[int64_t(t) * B + b] = x;"),
                  ("      if (dbase) dbase[k] = x;\n"
                   "      if (need_o) dcoef[k] = x * ov[i];",
                   "      if (x == -1.f) dbase[k] = dcoef[k] = x;")]),
]
_VTRACE = [  # vtrace_short and vtrace_tiled<K>
    ("no_loads", [_LOAD_TILE,
                  ("    lr[i] = ld_nc(p.log_rhos + t * p.lr_s0 + bc * p.lr_s1);\n"
                   "    g[i] = ld_nc(p.discounts + t * p.d_s0 + bc * p.d_s1);\n"
                   "    r[i] = ld_nc(p.rewards + t * p.r_s0 + bc * p.r_s1);\n"
                   "    v[i] = ld_nc(p.values + t * p.v_s0 + bc * p.v_s1);",
                   "    lr[i] = 0.1f * i;\n    g[i] = 0.5f;\n"
                   "    r[i] = float(i);\n    v[i] = 1.f;"),
                  ("  v[R] = ld_nc(p.values + int64_t(min(t0 + R, T - 1)) * "
                   "p.v_s0 +\n               bc * p.v_s1);", "  v[R] = 1.f;"),
                  ("const float boot = ld_nc(p.bootstrap + bc * p.boot_s);",
                   "const float boot = 1.f;"),
                  ("const float boot = b < B ? ld_nc(p.bootstrap + int64_t(b) "
                   "* p.boot_s)\n                           : 0.f;",
                   "const float boot = 1.f;")]),
    ("no_prologue", [("  const float e = expf(log_rho);\n"
                      "  const float rho = fminf(clip_rho, e);\n"
                      "  return {rho, g * fminf(clip_c, e), "
                      "rho * (r + g * v_next - v)};",
                      "  return {log_rho, g, r};")]),
    ("no_chain", [("Bv = fmaf(st[i].coef, Bv, st[i].delta);",
                   "Bv = st[i].delta;"),
                  ("Bv = fmaf(st[s].coef, Bv, st[s].delta);",
                   "Bv = st[s].delta;"),
                  ("if (u > w) x = fmaf(sC[u][lane], x, sB[u][lane]);", ";"),
                  ("for (int d = 1; d < 32; d <<= 1) {",
                   "for (int d = 1; d < 1; d <<= 1) {"),
                  ("x = fmaf(st[i].coef, x, st[i].delta);",
                   "x = st[i].delta;"),
                  ("acc = fmaf(st[s].coef, acc, st[s].delta);",
                   "acc = st[s].delta;")]),
    ("no_epilogue", [("return s.rho * (r + g * vs_next - v);",
                      "return vs_next;")]),
    ("no_store", [_STORE_OUT,
                  ("p.pg_adv[k] = pg_adv(", "if (x == -1.f) p.pg_adv[k] = "
                                            "pg_adv("),
                  ("p.vs[k] = v[i] + x;", "if (x == -1.f) p.vs[k] = v[i] + x;")]),
]
# the backward's design alternatives (flash_attention_bwd.cu), measured
# whole
_FLASH_BWD = [
    *((f"groups{w}", [("constexpr int kWarps = 4;",
                       f"constexpr int kWarps = {w};")]) for w in (1, 2, 8)),
    ("rows4", [("static constexpr int R = D <= 128 ? 8 : 4;",
                "static constexpr int R = 4;")]),
    ("unpadded", [("static constexpr int DP = D + 16;",
                   "static constexpr int DP = D;")]),
    ("keys2", [("#pragma unroll 1  // keys in turn",
                "#pragma unroll 2  // keys in turn")]),
    ("uncapped", [("static constexpr int kMinBlocks = D <= 64 ? 4 : 1;",
                   "static constexpr int kMinBlocks = 1;")]),
    ("scalar", [("const bool vec = (ptrs",
                 "const bool vec = false && (ptrs")]),
    # its time to two points, the output then wrong: once the round's
    # copies have landed, and after phase 1
    ("to_loads", [("    sm90::cp_async_wait<0>();\n    __syncwarp();\n",
                   "    sm90::cp_async_wait<0>();\n    __syncwarp();\n"
                   "    if (blockDim.x > 0) return;\n")]),
    ("to_phase1", [("    __syncwarp();\n\n    // phase 2:",
                    "    __syncwarp();\n    if (blockDim.x > 0) return;"
                    "\n\n    // phase 2:")]),
]
for _cuts in (_FLASH_SHORT, _SCAN, _VTRACE):
    _cuts.append(("skeleton", [c for _, cs in _cuts for c in cs]))
# beyond the parts: `launch`, the grid returning at once (its launch and
# block scheduling, nothing else); `loads_only`, returning once the tiles
# are in shared memory; and design alternatives, each measured whole
_RET = "if (blockDim.x > 0) return;"
_FLASH_SHORT += [
    ("launch", [("float sh_short[];\n", f"float sh_short[];\n  {_RET}\n"),
                ("flash_short_reg_f32(Args a, int B, int ng, int tiles) {\n",
                 "flash_short_reg_f32(Args a, int B, int ng, int tiles) {\n"
                 f"  {_RET}\n")]),
    ("loads_only", [("  __syncthreads();\n\n  // this warp's rows",
                     f"  __syncthreads();\n  {_RET}\n  // this warp's rows")])]
_SCAN += [
    ("launch", [("extern __shared__ float smem[];\n",
                 f"extern __shared__ float smem[];\n  {_RET}\n"),
                ("__shared__ float sC[kWarps][32], sB[kWarps][32];\n",
                 f"__shared__ float sC[kWarps][32], sB[kWarps][32];\n"
                 f"  {_RET}\n")]),
    ("loads_only", [("    __syncthreads();\n    if (p > 0) {",
                     f"    __syncthreads();\n    {_RET}\n    if (p > 0) {{"),
                    ("    __syncthreads();\n    if (p + 1 < passes) {",
                     f"    __syncthreads();\n    {_RET}\n"
                     "    if (p + 1 < passes) {")]),
    ("tiled_t32", [("if (p->T <= kShortT) {", "if (false) {")])]
_VTRACE += [
    ("launch", [("extern __shared__ float smem[];\n",
                 f"extern __shared__ float smem[];\n  {_RET}\n"),
                ("__shared__ float sC[kWarps][32], sB[kWarps][32];\n",
                 f"__shared__ float sC[kWarps][32], sB[kWarps][32];\n"
                 f"  {_RET}\n")]),
    ("loads_only", [("    __syncthreads();\n    if (pass > 0) {",
                     f"    __syncthreads();\n    {_RET}\n"
                     "    if (pass > 0) {")])]
_STUB = ('#include <cuda_runtime.h>\nextern "C" const char* '
         'repro_cuda_error_string(int c) { return cudaGetErrorString('
         'static_cast<cudaError_t>(c)); }\n')


def events_ms(fn, iters):
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_inputs(case, dev, seed=0):
    B, H, KVH, S, D, _, _ = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    G = H // KVH
    return (torch.randn((B, S, KVH, G, D), generator=gen, device=dev),
            torch.randn((B, S, KVH, D), generator=gen, device=dev),
            torch.randn((B, S, KVH, D), generator=gen, device=dev))


def scan_inputs(T, B, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    base, g = (torch.randn((T, B), generator=gen, device=dev)
               for _ in range(2))
    coef = 0.99 * torch.rand((T, B), generator=gen, device=dev)
    init = torch.randn((B,), generator=gen, device=dev)
    return base, coef, init, g, discounted_return_ref(base, coef, init)


def vtrace_inputs(T, B, dev, seed=0):
    """log rho, discounts, rewards, values (T, B) and the bootstrap (B,),
    as chip_smoke's scan phase draws them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    log_rhos = 0.5 * torch.randn((T, B), generator=gen, device=dev)
    discounts = 0.99 * torch.rand((T, B), generator=gen, device=dev)
    rewards, values = (torch.randn((T, B), generator=gen, device=dev)
                       for _ in range(2))
    return (log_rhos, discounts, rewards, values,
            torch.randn((B,), generator=gen, device=dev))


def train_inputs(case, dev, seed=0):
    """(q, k, v, o, lse, do) of a trunk training call, (B,H,S,D) views of
    the model layout as the autograd Function hands them over, o and lse
    from the training forward."""
    B, H, KVH, S, D = case
    qg, k, v = flash_inputs((B, H, KVH, S, D, True, 0), dev, seed)
    q, kt, vt = (qg.reshape(B, S, H, D).transpose(1, 2), k.transpose(1, 2),
                 v.transpose(1, 2))
    o, lse = flash_kernel.flash_attention_fwd_lse(q, kt, vt)
    return q, kt, vt, o, lse, torch.randn_like(qg).reshape(
        B, S, H, D).transpose(1, 2)


def calls(dev):
    """{label: a call of a wrapper} for the sweep."""
    out = {}
    # an older tree measured with this tool may have no training attention
    train = TRAIN if hasattr(flash_kernel, "flash_attention_bwd") else []
    for case in train:
        q, k, v, o, lse, do = train_inputs(case, dev)
        out[f"flash_attention_fwd_lse {case}"] = (
            lambda a=(q, k, v): flash_kernel.flash_attention_fwd_lse(*a),
            200)
        out[f"flash_attention_hsd {case}"] = (   # the same, without lse
            lambda a=(q, k, v): flash_kernel.flash_attention_hsd(*a), 200)
        out[f"flash_attention_bwd {case}"] = (
            lambda a=(q, k, v, o, lse, do):
            flash_kernel.flash_attention_bwd(*a), 200)
    for case in dict.fromkeys(TRUNK + KERNEL_CASES):
        qg, k, v = flash_inputs(case, dev)
        causal, window = case[5], case[6]
        out[f"flash f32 {case}"] = (
            lambda qg=qg, k=k, v=v, c=causal, w=window:
            flash_attention(qg, k, v, causal=c, window=w),
            200 if case[3] <= 128 else 50)
    for T, B in SCAN_SHAPES:
        base, coef, init, g, o = scan_inputs(T, B, dev)
        out[f"discounted_return_tb {(T, B)}"] = (
            lambda a=(base, coef, init):
            scan_kernel.discounted_return_tb(*a), 200)
        out[f"discounted_return_adjoint_tb {(T, B)}"] = (
            lambda a=(g, coef, o, init):
            scan_kernel.discounted_return_adjoint_tb(*a), 200)
        if (T, B) == SCAN_SHAPES[0]:
            out[f"discounted_return_adjoint_tb dinit {(T, B)}"] = (
                lambda a=(g, coef, o, init):
                scan_kernel.discounted_return_adjoint_tb(
                    *a, need=(False, False, True)), 200)
        out[f"vtrace_tb {(T, B)}"] = (
            lambda a=vtrace_inputs(T, B, dev): vtrace_kernel.vtrace_tb(*a),
            200)
    return out


def bwd_case_inputs(case, dev):
    """train_inputs of a BWD_EXTRA or TRAIN case; with a float offset
    every operand is a view one float into a larger buffer."""
    B, H, KVH, S, D = case[:5]
    q, k, v, o, lse, do = train_inputs((B, H, KVH, S, D), dev)
    if len(case) < 6 or not case[5]:
        return q, k, v, o, lse, do

    def shifted(t):
        buf = torch.empty(t.numel() + case[5], device=dev)
        view = buf[case[5]:].view(t.transpose(1, 2).shape).transpose(1, 2)
        view.copy_(t)
        return view
    return (*(shifted(t) for t in (q, k, v, o)), lse, shifted(do))


def bwd_variants(tmp, dev, parents, reps):
    """{case: {library: {max_abs_err, device_us: [...], launch_floor_us:
    [...]}}} of the backward at TRAIN + BWD_EXTRA (the --bwd sweep)."""
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    source = (common.PACKAGE_DIR / "kernels" / "flash_attention" / "csrc" /
              "flash_attention_bwd.cu")
    libs = build_variants(Path(tmp) / "bwd", source, _FLASH_BWD)
    for i, parent in enumerate(parents):
        name = "parent" if len(parents) == 1 else f"parent{i}"
        libs[name] = build_variants(Path(tmp) / name, Path(parent),
                                    [])["whole"]
    order = list(libs)
    out = {}
    for case in [(*c, 0) for c in TRAIN] + BWD_EXTRA:
        behind(flash_kernel, common.load_kernels())  # the forward's
        args = bwd_case_inputs(case, dev)
        want = attention_bwd_ref(*args)
        row = {}
        for name, dll in libs.items():
            behind(flash_kernel, dll)
            got = flash_kernel.flash_attention_bwd(*args)
            row[name] = {"max_abs_err": max(
                (g - w).abs().max().item() for g, w in zip(got, want)),
                "device_us": [], "launch_floor_us": []}
        for _ in range(reps):
            for name in order + order[::-1]:
                behind(flash_kernel, libs[name])
                us, floor, _ = beside_floor(
                    lambda: flash_kernel.flash_attention_bwd(*args))
                row[name]["device_us"].append(us)
                row[name]["launch_floor_us"].append(floor)
        out[str(case)] = row
    behind(flash_kernel, common.load_kernels())
    return out


def sweep(dev):
    out = {}
    for label, (fn, iters) in calls(dev).items():
        us, floor, launches = beside_floor(fn)
        out[label] = {"device_us": us, "launch_floor_us": floor,
                      "device_kernels": launches,
                      "ms": events_ms(fn, iters)}
    return out


def build_texts(source):
    """{path relative to the kernels directory: text} of a kernel source
    and of the shared headers (kernels/shared/csrc/*.cuh) its build
    reads."""
    kdir = Path(source).parents[2]
    files = [Path(source), *sorted((kdir / "shared" / "csrc").glob("*.cuh"))]
    return {f.relative_to(kdir): f.read_text() for f in files}


def missing_texts(text, cuts):
    """[(variant, text)] of every cut text that `text` does not hold."""
    return [(name, old) for name, reps in cuts for old, _ in reps
            if old not in text]


def write_variant(root, texts, reps):
    """Write `texts` (build_texts) under `root` as they lie in the
    package, each with the replacements `reps` made wherever their texts
    stand; returns the source's copy."""
    for rel, text in texts.items():
        for old, new in reps:
            text = text.replace(old, new)
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    return root / next(iter(texts))


def build_variants(tmp, source, cuts):
    """{variant: its library}, each compiled from copies of `source` and
    the shared headers, laid out as in the package (so its includes
    resolve to the copies), with its replacements made wherever their
    texts stand (every build started at once). Raises if a cut's text is
    in none of them."""
    texts = build_texts(source)
    missing = missing_texts("\n".join(texts.values()), cuts)
    if missing:
        raise ValueError(f"{Path(source).name} and its headers no longer "
                         f"hold the cut texts {missing}")
    procs = {}
    for name, reps in [("whole", [])] + cuts:
        srcs = [write_variant(Path(tmp) / name, texts, reps)]
        if "repro_cuda_error_string" not in srcs[0].read_text():
            srcs.append(Path(tmp) / name / "stub.cu")  # check_launch's
            srcs[1].write_text(_STUB)
        procs[name] = subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, "-shared", *map(str, srcs),
             "-o", str(Path(tmp) / f"{name}.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        dll = ctypes.CDLL(str(Path(tmp) / f"{name}.so"))
        dll.repro_cuda_error_string.argtypes = [ctypes.c_int]
        dll.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = dll
    return libs


def behind(module, dll):
    """Make `module`'s wrappers launch from `dll`: its launcher cache is
    cleared and its `load_kernels` returns dll."""
    module.load_kernels = lambda: dll
    for name in ("_launcher", "_launchers"):
        if hasattr(module, name):
            getattr(module, name).cache_clear()


def ablate(tmp, dev):
    kdir = common.PACKAGE_DIR / "kernels"
    for sub in ("flash", "scan", "vtrace"):
        (Path(tmp) / sub).mkdir()
    flash_libs = build_variants(
        Path(tmp) / "flash",
        kdir / "flash_attention" / "csrc" / "flash_attention.cu",
        _FLASH_SHORT)
    scan_libs = build_variants(
        Path(tmp) / "scan", kdir / "advantages" / "csrc" / "advantages.cu",
        _SCAN)
    vtrace_libs = build_variants(
        Path(tmp) / "vtrace", kdir / "vtrace" / "csrc" / "vtrace.cu", _VTRACE)
    out = {"flash": {}, "scans": {}, "vtrace": {}}
    for case in ABLATE_FLASH:
        qg, k, v = flash_inputs(case, dev)
        row = {}
        for name, dll in flash_libs.items():
            behind(flash_kernel, dll)
            us, floor, _ = beside_floor(lambda: flash_attention(qg, k, v))
            row[name] = {"device_us": us, "launch_floor_us": floor}
        out["flash"][str(case)] = row
    for T, B in ABLATE_SCANS:
        base, coef, init, g, o = scan_inputs(T, B, dev)
        row = {}
        for name, dll in scan_libs.items():
            behind(scan_kernel, dll)
            fwd, _, _ = beside_floor(
                lambda: scan_kernel.discounted_return_tb(base, coef, init))
            adj, floor, _ = beside_floor(
                lambda: scan_kernel.discounted_return_adjoint_tb(
                    g, coef, o, init))
            row[name] = {"forward_device_us": fwd, "adjoint_device_us": adj,
                         "launch_floor_us": floor}
        out["scans"][str((T, B))] = row
        args = vtrace_inputs(T, B, dev)
        row = {}
        for name, dll in vtrace_libs.items():
            behind(vtrace_kernel, dll)
            us, floor, _ = beside_floor(lambda: vtrace_kernel.vtrace_tb(*args))
            row[name] = {"device_us": us, "launch_floor_us": floor}
        out["vtrace"][str((T, B))] = row
    for module in (flash_kernel, scan_kernel, vtrace_kernel):
        behind(module, common.load_kernels())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.profile_small_kernels")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--bwd", action="store_true",
                    help="time the flash backward's variants")
    ap.add_argument("--bwd-parent", action="append", default=[],
                    help="an older flash_attention_bwd.cu to time beside "
                         "(repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_small_kernels measures the card; torch "
                           "sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    with torch.no_grad():
        if args.ablate:
            with tempfile.TemporaryDirectory() as tmp:
                print(json.dumps({"card": card(), "ablate": ablate(tmp,
                                                                   dev)}))
            return
        if args.bwd:
            with tempfile.TemporaryDirectory() as tmp:
                print(json.dumps({"card": card(), "bwd": bwd_variants(
                    tmp, dev, args.bwd_parent, args.reps)}))
            return
        reps = [sweep(dev) for _ in range(args.reps)]
    print(json.dumps({"card": card(), "reps": reps}))


if __name__ == "__main__":
    main()
