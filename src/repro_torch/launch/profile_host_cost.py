"""Host time of one kernel wrapper call and of its pieces, on the card:
where the CUDA-event time of a small kernel goes when the host, not the
card, sets it.

    PYTHONPATH=src python -m repro_torch.launch.profile_host_cost
    PYTHONPATH=src python -m repro_torch.launch.profile_host_cost \
        --parent OLD_CHECKOUT [--parent OLDER_CHECKOUT] [--pairs 8]

Times, in us per call over 2000 calls without a sync (the host's enqueue
only):
- `shard_topk_c` at the replay=2 DQN path shape (R = 2 shards of 10000
  slots, counts 10000 and 2800, k = 64), batched `torch.topk` over the
  same scores, and the wrapper's pieces: an output allocation, the
  argument checks, entering the device (`on_device`, and
  `torch.cuda.device` for comparison) and reading the current stream
  (`launch_stream`, and `torch.cuda.current_stream().cuda_stream`);
- `flash_attention` (ops.py, the model's entry) at the two LM prefill
  shapes (deepseek-moe-16b (B, H, KVH, S, D) = (4, 16, 16, 32, 128) and
  smollm-360m (4, 15, 5, 32, 64), bf16, causal), the kernel wrapper
  `flash_attention_hsd` on (B, H, S, D) views, SDPA on the same inputs,
  and the pieces: the checks with the packing of the arguments, the
  packing alone, the output allocation and the ctypes call itself;
- `prioritized_sample_c` at the flat DQN path shape (C, size, n) =
  (20000, 12800, 64), `torch.topk` over the scores, and its pieces: the
  checks, the one allocation and the ctypes call itself;
- the chunked WKV at the rwkv6-1.6b serve shapes (B, T, H, N) =
  (4, 1, 32, 64) (a decode step, chunk 1) and (4, 32, 32, 64) (the
  prefill, chunk 64), each with a carried f32 state: `ops.wkv6` (the
  model's entry) on bf16 r, k, v and u as the serve path hands them over,
  the kernel wrapper `wkv6_btHN` on f32 inputs, and its pieces: the
  checks, the allocation of y, the casts of r, k, v and u from bf16 to
  f32 (what an entry that takes f32 only must add), and the ctypes call
  itself (one packed argument);
- the discounted-return scan `discounted_return_tb` and its adjoint
  `discounted_return_adjoint_tb` at the training path's (T, B) =
  (32, 32) (the adjoint with every gradient, and with dinit alone, A3C's
  call), and their pieces: the argument checks (`check_tb`), the output
  allocation (`torch.empty`, and `Tensor.new_empty`, which the wrappers
  use), the packing of the arguments and the ctypes call itself
  (one packed argument);
- `vtrace_tb` at the training path's (T, B) = (32, 32), and its pieces:
  the argument checks, the two output allocations (`new_empty`), the
  packing of the arguments and the ctypes call itself (one packed
  argument);
- `flash_attention` (ops.py, the policy trunk's entry) in f32 at the
  trunk's serving shape (B, H, KVH, S, D) = (32, 4, 2, 4, 64), causal,
  with the same pieces as the bf16 rows;
- the trunk's training attention at a full-width PPO minibatch
  (B, H, KVH, S, D) = (256, 4, 2, 4, 64): the backward kernel's wrapper
  `flash_attention_bwd`, the training forward `flash_attention_fwd_lse`,
  the autograd backward of `flash_attention` (its Function) and of SDPA
  on the same inputs, and the backward wrapper's pieces: the checks with
  the packing of the arguments, the one allocation of its outputs and
  their three views (beside three allocations of their own, the older
  wrapper's) and the ctypes call itself (one packed argument).
Prints one JSON line beside the card's name and power limit.

With `--parent` (once or more), it measures nothing else: the whole
calls of the training path's small kernels (`vtrace_tb`,
`discounted_return_tb`, the adjoint with every gradient and with dinit
alone, at (32, 32); the flash backward's wrapper and the whole autograd
backward of `flash_attention` at the full-width ppo minibatch) in
rounds of processes, one on the package of each
checkout given and one on this one's, the order rotating from round to
round, after a warm-up process per checkout (the kernel builds). A
process times each call ROUNDS times, the calls in turns, and reports
the median, beside the host's load average (`os.getloadavg()`) before
and after and its CPU time over its wall time while it measured (below
1: the process waited for a core). Needs a card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels.advantages import kernel as scan_kernel
from repro_torch.kernels.common import check_tb, launch_stream, on_device
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.replay_sample import kernel as replay_kernel
from repro_torch.kernels.replay_sample.kernel import shard_topk_c
from repro_torch.kernels.vtrace import kernel as vtrace_kernel
from repro_torch.kernels.wkv6 import kernel as wkv_kernel
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.launch.profiling import card

LM_FLASH = {"deepseek-moe-16b": (4, 16, 16, 32, 128),
            "smollm-360m": (4, 15, 5, 32, 64)}
REPLAY = (20000, 12800, 64)
SCAN = (32, 32)                 # (T, B) of the training path
TRUNK_FLASH = (32, 4, 2, 4, 64)  # the policy trunk's serve shape, f32
TRUNK_TRAIN = (256, 4, 2, 4, 64)  # a full-width ppo minibatch, f32
# (B, T, H, N, chunk) of the rwkv6-1.6b serve path
WKV = {"decode": (4, 1, 32, 64, 1), "prefill": (4, 32, 32, 64, 64)}
ROUNDS = 5   # timings of each call in a process of a pair, in turns


def per_call_us(fn, n=2000):
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def shard_costs(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    prio = torch.rand((2, 10000), generator=gen, device=dev) + 0.01
    gumbel = torch.rand((2, 10000), generator=gen, device=dev)
    nvalid = torch.tensor([10000, 2800], dtype=torch.int32, device=dev)

    def enter(ctx):
        with ctx:
            pass

    return {
        "shard_topk_c": per_call_us(
            lambda: shard_topk_c(prio, gumbel, nvalid, 64)),
        "torch.topk": per_call_us(lambda: torch.topk(prio, 64, dim=-1)),
        "torch.empty": per_call_us(
            lambda: torch.empty((2, 2, 64), dtype=torch.int32, device=dev)),
        "checks": per_call_us(lambda: [
            (t.dtype, t.device != dev, t.is_contiguous())
            for t in (prio, gumbel, nvalid)]),
        "on_device": per_call_us(lambda: enter(on_device(dev))),
        "torch.cuda.device": per_call_us(
            lambda: enter(torch.cuda.device(dev))),
        "launch_stream": per_call_us(lambda: launch_stream(dev)),
        "torch.cuda.current_stream": per_call_us(
            lambda: torch.cuda.current_stream().cuda_stream)}


def flash_costs(dev, shape, dtype=torch.bfloat16):
    B, H, KVH, S, D = shape
    G = H // KVH
    gen = torch.Generator(device=dev).manual_seed(0)
    qg = torch.randn((B, S, KVH, G, D), generator=gen,
                     device=dev).to(dtype)
    k = torch.randn((B, S, KVH, D), generator=gen,
                    device=dev).to(dtype)
    v = torch.randn_like(k)
    q_hsd = qg.reshape(B, S, H, D).transpose(1, 2)
    k_hsd, v_hsd = k.transpose(1, 2), v.transpose(1, 2)
    qc, kc, vc = (t.contiguous() for t in (q_hsd, k_hsd, v_hsd))
    out = torch.empty_like(qg)
    _, fn = flash_kernel._launcher()
    params = flash_kernel.grouped_params(qg, k, v, out, True, 0)
    fields = flash_kernel.PARAMS.unpack(params)

    with torch.no_grad():
        return {
            "flash_attention": per_call_us(
                lambda: flash_attention(qg, k, v, causal=True)),
            "flash_attention_hsd": per_call_us(
                lambda: flash_kernel.flash_attention_hsd(q_hsd, k_hsd,
                                                         v_hsd)),
            "sdpa": per_call_us(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True, enable_gqa=True)),
            "checks and packed arguments": per_call_us(
                lambda: flash_kernel.grouped_params(qg, k, v, out, True, 0)),
            "pack alone": per_call_us(
                lambda: flash_kernel.PARAMS.pack(*fields)),
            "torch.empty": per_call_us(lambda: torch.empty(
                qg.shape, dtype=qg.dtype, device=dev)),
            "ctypes call (2 args)": per_call_us(
                lambda: fn(params, launch_stream(dev)))}


def train_attention(dev, shape):
    """The trunk's training attention at `shape` (B, H, KVH, S, D): (q,
    k, v, o, lse, do) as the autograd Function hands them to the backward
    wrapper, and (its output under grad, its inputs, the cotangent) for
    a whole autograd backward."""
    B, H, KVH, S, D = shape
    G = H // KVH
    gen = torch.Generator(device=dev).manual_seed(0)
    qg = torch.randn((B, S, KVH, G, D), generator=gen, device=dev)
    k, v = (torch.randn((B, S, KVH, D), generator=gen, device=dev)
            for _ in range(2))
    dout = torch.randn_like(qg)
    q, kt, vt = (qg.reshape(B, S, H, D).transpose(1, 2), k.transpose(1, 2),
                 v.transpose(1, 2))
    o, lse = flash_kernel.flash_attention_fwd_lse(q, kt, vt)
    do = dout.reshape(B, S, H, D).transpose(1, 2)
    ins = [t.clone().requires_grad_() for t in (qg, k, v)]
    return (q, kt, vt, o, lse, do), (flash_attention(*ins), ins, dout)


def flash_bwd_costs(dev, shape):
    B, H, KVH, S, D = shape
    G = H // KVH
    (q, kt, vt, o, lse, do), (out, ins, dout) = train_attention(dev, shape)
    qc, kc, vc = (t.detach().contiguous().requires_grad_()
                  for t in (q, kt, vt))
    ref = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                         enable_gqa=True)
    _, fn = flash_kernel._launcher("flash_attention_bwd")
    dq, dk, dv = flash_kernel.flash_attention_bwd(q, kt, vt, o, lse, do)
    qs, ks, vs, os_, ds = (t.stride()[:3] for t in (q, kt, vt, o, do))
    nq, nk = B * S * H * D, B * S * KVH * D

    def pack():
        # the wrapper's checks (_check, _short_f32, o, do and lse in one
        # pass) and its packing
        dt, kv_end = flash_kernel._check(q, kt, vt, None)
        flash_kernel._short_f32("flash_attention_bwd", dt, kv_end, B, KVH,
                                S, G)
        f32, d = torch.float32, q.get_device()
        if o.shape != q.shape or do.shape != q.shape or \
                lse.shape != (B, H, S) or o.dtype != f32 or \
                do.dtype != f32 or lse.dtype != f32 or \
                o.get_device() != d or do.get_device() != d or \
                lse.get_device() != d or o.stride(-1) != 1 or \
                do.stride(-1) != 1 or not lse.is_contiguous():
            raise ValueError("flash_bwd_costs: operands the wrapper refuses")
        return flash_kernel.BWD_PARAMS.pack(
            q.data_ptr(), kt.data_ptr(), vt.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, KVH, S, D, 1, 0, S, D ** -0.5, *qs, *ks,
            *vs, *os_, *ds, S * H * D, D, H * D, S * KVH * D, D, KVH * D,
            S * KVH * D, D, KVH * D)

    params = pack()
    buf = torch.empty(nq + 2 * nk, device=dev)
    kv = (S * KVH * D, D, KVH * D, 1)
    return {
        "flash_attention_bwd": per_call_us(
            lambda: flash_kernel.flash_attention_bwd(q, kt, vt, o, lse, do)),
        "flash_attention_fwd_lse": per_call_us(
            lambda: flash_kernel.flash_attention_fwd_lse(q, kt, vt)),
        "flash_attention autograd backward": per_call_us(
            lambda: torch.autograd.grad(out, ins, dout, retain_graph=True)),
        "sdpa autograd backward": per_call_us(
            lambda: torch.autograd.grad(ref, (qc, kc, vc), do,
                                        retain_graph=True)),
        "checks and packed arguments": per_call_us(pack),
        "torch.empty (one buffer)": per_call_us(
            lambda: torch.empty(nq + 2 * nk, device=dev)),
        "as_strided x3 (the outputs' views)": per_call_us(lambda: (
            buf.as_strided((B, H, S, D), (S * H * D, D, H * D, 1)),
            buf.as_strided((B, KVH, S, D), kv, nq),
            buf.as_strided((B, KVH, S, D), kv, nq + nk))),
        "torch.empty x3 (three buffers)": per_call_us(lambda: [
            torch.empty((B, S, H, D), device=dev),
            torch.empty((B, S, KVH, D), device=dev),
            torch.empty((B, S, KVH, D), device=dev)]),
        "ctypes call (2 args)": per_call_us(
            lambda: fn(params, launch_stream(dev)))}


def replay_costs(dev):
    C, size, n = REPLAY
    gen = torch.Generator(device=dev).manual_seed(0)
    prio = torch.rand((C,), generator=gen, device=dev) + 0.01
    gumbel = torch.rand((C,), generator=gen, device=dev)
    s = torch.tensor([size], dtype=torch.int32, device=dev)
    scores = torch.where(torch.arange(C, device=dev) < size,
                         0.6 * torch.log(prio + 1e-6) + gumbel, -torch.inf)
    words = replay_kernel.buffer_words(C, n)
    buf = torch.empty((words,), dtype=torch.int32, device=dev)
    _, fn = replay_kernel._launcher()
    args = replay_kernel._args(prio, gumbel, s, n, 0.6, 0.4, 1e-6, buf)
    return {
        "prioritized_sample_c": per_call_us(
            lambda: replay_kernel.prioritized_sample_c(prio, gumbel, s, n)),
        "torch.topk": per_call_us(lambda: torch.topk(scores, n)),
        "checks": per_call_us(
            lambda: replay_kernel._check(prio, gumbel, s, n)),
        "torch.empty": per_call_us(lambda: torch.empty(
            (words,), dtype=torch.int32, device=dev)),
        f"ctypes call ({len(args) + 1} args)": per_call_us(
            lambda: fn(*args, launch_stream(dev)))}


def wkv_costs(dev, shape):
    B, T, H, N, L = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    r, k, v = (torch.randn((B, T, H, N), generator=gen, device=dev)
               for _ in range(3))
    logw = -torch.exp(0.5 * torch.randn((B, T, H, N), generator=gen,
                                        device=dev))
    u = 0.3 + 0.2 * torch.randn((H, N), generator=gen, device=dev)
    state = 0.2 * torch.randn((B, H, N, N), generator=gen, device=dev)
    rb, kb, vb, ub = (a.to(torch.bfloat16) for a in (r, k, v, u))
    y = torch.empty_like(r)
    _, fn = wkv_kernel._launcher()
    stream = launch_stream(dev)
    args = (wkv_kernel.PARAMS.pack(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), state.data_ptr(), y.data_ptr(), state.data_ptr(),
        B, T, H, N, L, 0), stream)
    with torch.no_grad():
        return {
            "ops.wkv6 (bf16 r, k, v, u)": per_call_us(
                lambda: wkv_ops.wkv6(rb, kb, vb, logw, ub, L, state)),
            "wkv6_btHN (f32)": per_call_us(
                lambda: wkv_kernel.wkv6_btHN(r, k, v, logw, u, state,
                                             chunk=L)),
            "checks": per_call_us(
                lambda: wkv_kernel._check(r, k, v, logw, u, state, L)),
            "torch.empty": per_call_us(lambda: torch.empty(
                (B, T, H, N), dtype=torch.float32, device=dev)),
            "casts to f32 (r, k, v, u)": per_call_us(lambda: [
                a.float().contiguous() for a in (rb, kb, vb, ub)]),
            f"ctypes call ({len(args)} args)": per_call_us(
                lambda: fn(*args))}


def scan_inputs(dev):
    """base, g (T, B), coef (T, B) in [0, 0.99), init (B,) at SCAN."""
    T, B = SCAN
    gen = torch.Generator(device=dev).manual_seed(0)
    base, g = (torch.randn((T, B), generator=gen, device=dev)
               for _ in range(2))
    coef = 0.99 * torch.rand((T, B), generator=gen, device=dev)
    return base, g, coef, torch.randn((B,), generator=gen, device=dev)


def scan_costs(dev):
    T, B = SCAN
    base, g, coef, init = scan_inputs(dev)
    out = scan_kernel.discounted_return_tb(base, coef, init)
    dbase, dcoef, dinit = (torch.empty_like(t) for t in (base, base, init))
    _, fwd, adj = scan_kernel._launchers()
    stream = launch_stream(dev)
    fwd_args = (scan_kernel.fwd_params(base, coef, init, out), stream)
    adj_args = (scan_kernel.adj_params(g, coef, out, init, dbase, dcoef,
                                       dinit), stream)
    return {
        "discounted_return_tb": per_call_us(
            lambda: scan_kernel.discounted_return_tb(base, coef, init)),
        "discounted_return_adjoint_tb": per_call_us(
            lambda: scan_kernel.discounted_return_adjoint_tb(
                g, coef, out, init)),
        "discounted_return_adjoint_tb (dinit alone)": per_call_us(
            lambda: scan_kernel.discounted_return_adjoint_tb(
                g, coef, out, init, need=(False, False, True))),
        "checks (forward)": per_call_us(lambda: check_tb(
            "discounted_return_tb", T, B, (base, coef), (init,))),
        "checks (adjoint)": per_call_us(lambda: check_tb(
            "discounted_return_adjoint_tb", T, B, (g, coef, out), (init,))),
        "torch.empty": per_call_us(lambda: torch.empty(
            (T, B), dtype=torch.float32, device=dev)),
        "new_empty": per_call_us(lambda: base.new_empty((T, B))),
        "pack (forward)": per_call_us(
            lambda: scan_kernel.fwd_params(base, coef, init, out)),
        "pack (adjoint)": per_call_us(
            lambda: scan_kernel.adj_params(g, coef, out, init, dbase, dcoef,
                                           dinit)),
        f"ctypes call (forward, {len(fwd_args)} args)": per_call_us(
            lambda: fwd(*fwd_args)),
        f"ctypes call (adjoint, {len(adj_args)} args)": per_call_us(
            lambda: adj(*adj_args))}


def vtrace_inputs(dev):
    T, B = SCAN
    gen = torch.Generator(device=dev).manual_seed(0)
    log_rhos = 0.5 * torch.randn((T, B), generator=gen, device=dev)
    discounts = 0.99 * torch.rand((T, B), generator=gen, device=dev)
    rewards, values = (torch.randn((T, B), generator=gen, device=dev)
                       for _ in range(2))
    return (log_rhos, discounts, rewards, values,
            torch.randn((B,), generator=gen, device=dev))


def vtrace_costs(dev):
    T, B = SCAN
    args = vtrace_inputs(dev)
    vs, adv = (torch.empty((T, B), device=dev) for _ in range(2))
    _, fn = vtrace_kernel._launcher()
    call = (vtrace_kernel.vtrace_params(*args, vs, adv, 1.0, 1.0),
            launch_stream(dev))
    return {
        "vtrace_tb": per_call_us(lambda: vtrace_kernel.vtrace_tb(*args)),
        "checks": per_call_us(lambda: check_tb(
            "vtrace_tb", T, B, args[:4], args[4:])),
        "new_empty (vs, pg_adv)": per_call_us(
            lambda: (args[0].new_empty((T, B)), args[0].new_empty((T, B)))),
        "pack": per_call_us(
            lambda: vtrace_kernel.vtrace_params(*args, vs, adv, 1.0, 1.0)),
        f"ctypes call ({len(call)} args)": per_call_us(lambda: fn(*call))}


def whole_calls():
    """The whole calls of the training path's small kernels, with the
    host's load around them: what one side of a pair prints. Uses only
    the wrappers' public signatures, which an older checkout shares."""
    dev = torch.device("cuda", torch.cuda.current_device())
    base, g, coef, init = scan_inputs(dev)
    out = scan_kernel.discounted_return_tb(base, coef, init)
    vt = vtrace_inputs(dev)
    calls = {
        "vtrace_tb": lambda: vtrace_kernel.vtrace_tb(*vt),
        "discounted_return_tb": lambda: scan_kernel.discounted_return_tb(
            base, coef, init),
        "discounted_return_adjoint_tb": lambda:
            scan_kernel.discounted_return_adjoint_tb(g, coef, out, init),
        "discounted_return_adjoint_tb (dinit alone)": lambda:
            scan_kernel.discounted_return_adjoint_tb(
                g, coef, out, init, need=(False, False, True))}
    if hasattr(flash_kernel, "flash_attention_bwd"):
        args, (fout, ins, dout) = train_attention(dev, TRUNK_TRAIN)
        calls["flash_attention_bwd"] = \
            lambda: flash_kernel.flash_attention_bwd(*args)
        calls["flash_attention autograd backward"] = \
            lambda: torch.autograd.grad(fout, ins, dout, retain_graph=True)
    for fn in calls.values():  # build, load and warm every path first
        fn()
    torch.cuda.synchronize()
    load0, cpu0, wall0 = os.getloadavg(), time.process_time(), \
        time.perf_counter()
    rounds = {name: [] for name in calls}
    for _ in range(ROUNDS):
        for name, fn in calls.items():
            rounds[name].append(per_call_us(fn))
    cpu, wall = time.process_time() - cpu0, time.perf_counter() - wall0
    return {"host_us_per_call": {name: statistics.median(us)
                                 for name, us in rounds.items()},
            "rounds": rounds, "loadavg_before": load0,
            "loadavg_after": os.getloadavg(), "cpu_over_wall": cpu / wall}


def side(checkout):
    """whole_calls() in a new process on `checkout`'s package (its
    src/ first on the path), run from that checkout."""
    code = ("import json, runpy; print(json.dumps(runpy.run_path("
            f"{str(Path(__file__).resolve())!r})['whole_calls']()))")
    env = dict(os.environ, PYTHONPATH=str(Path(checkout).resolve() / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"whole_calls on {checkout} failed:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def pairs(parents, n):
    """n rounds of one process per checkout (`parents`, then this tree,
    named "tree"), the order rotating by one each round."""
    sides = {str(p): p for p in parents}
    sides["tree"] = Path(__file__).resolve().parents[3]
    for checkout in sides.values():  # the builds, outside any round
        side(checkout)
    names = list(sides)
    out = []
    for i in range(n):
        order = names[i % len(names):] + names[:i % len(names)]
        out.append({"order": order,
                    **{name: side(sides[name]) for name in order}})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.profile_host_cost")
    ap.add_argument("--parent", action="append",
                    help="an older checkout to pair with (repeatable)")
    ap.add_argument("--pairs", type=int, default=8)
    args = ap.parse_args(argv)
    if args.parent:
        print(json.dumps({"card": card(),
                          "pairs": pairs(args.parent, args.pairs)}))
        return
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"card": card(), "host_us_per_call": shard_costs(dev)}
    out["flash_attention_bf16"] = {f"{name} {shape}": flash_costs(dev, shape)
                                   for name, shape in LM_FLASH.items()}
    out["flash_attention_f32_trunk"] = {
        f"paper-drl-trunk {TRUNK_FLASH}": flash_costs(dev, TRUNK_FLASH,
                                                      torch.float32)}
    out["flash_attention_bwd_trunk"] = {
        f"paper-drl-trunk {TRUNK_TRAIN}": flash_bwd_costs(dev, TRUNK_TRAIN)}
    out["discounted_return"] = {f"{SCAN}": scan_costs(dev)}
    out["vtrace_tb"] = {f"{SCAN}": vtrace_costs(dev)}
    out["prioritized_sample_c"] = replay_costs(dev)
    out["wkv6"] = {f"{name} {shape}": wkv_costs(dev, shape)
                   for name, shape in WKV.items()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
