"""Where an LM training step spends its time and memory on the card: the
step of `repro_torch.launch.train` at full width, split into the forward
(`LanguageModel.loss`), the backward (`torch.autograd.grad`) and the
optimizer (`Optimizer.apply_leafwise` of the launcher's clipped AdamW),
each on the host clock ending in a sync and each with its peak
allocation; then two steps under torch.profiler
(`launch/profiling.device_window`): device time and device operations a
step, the card's busy share and the kernels with the most device time.

    python experiments/lm_train_cost.py [--arch smollm-360m] [--batch 16]
        [--seq 128] [--steps 6] [--variants f32,bf16,remat]

Variants: `f32`, `bf16` (bf16 compute on f32 master weights, as
`train(dtype="bfloat16")`) and `remat` (f32 with `ModelOpts.remat`), each
from the same seed-0 params and the same `TokenStream` batches, in one
process, in turns. Prints one JSON line a variant beside the card's name
and power limit; the times are medians over the steps after the first.
Needs a card.
"""
import argparse
import json
import statistics
import time

import torch

VARIANTS = {"f32": ("float32", False), "bf16": ("bfloat16", False),
            "remat": ("float32", True)}


def measure(arch, dtype, remat, batch, seq, steps):
    from repro_torch.data import TokenStream
    from repro_torch.launch.profiling import device_window
    from repro_torch.launch.serve import stub_frontend
    from repro_torch.models.model import ModelOpts, build_model
    from repro_torch.optim import adamw, clip_by_global_norm, cosine_schedule
    torch.cuda.empty_cache()
    model = build_model(arch, ModelOpts(dtype=dtype, remat=remat))
    cfg = model.cfg
    optimizer = clip_by_global_norm(adamw(cosine_schedule(3e-4, 200,
                                                          warmup=10)), 1.0)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda", param_dtype=torch.float32)
    opt_state = optimizer.init(params)
    state_bytes = sum(t.numel() * t.element_size() for tree in (
        params, opt_state["m"], opt_state["v"]) for t in tree.values())
    stream = TokenStream(cfg.vocab, seq, batch)
    fe = stub_frontend(cfg, batch, "cuda")

    def batch_at(i):
        b = stream.batch_at(i, "cuda")
        if fe is not None:
            b["frontend"] = fe
        return b

    def stage(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, \
            torch.cuda.max_memory_allocated()

    def step(i):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        (loss, _), fwd_ms, fwd_peak = stage(
            lambda: model.loss(leaves, batch_at(i)))
        held = torch.cuda.memory_allocated()
        grads, bwd_ms, bwd_peak = stage(lambda: dict(zip(leaves, (
            torch.zeros_like(leaves[k]) if g is None else g
            for k, g in zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()), allow_unused=True))))))
        del loss, leaves
        _, opt_ms, opt_peak = stage(lambda: optimizer.apply_leafwise(
            params, opt_state, grads))
        return dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, opt_ms=opt_ms,
                    fwd_peak_bytes=fwd_peak, held_after_fwd_bytes=held,
                    bwd_peak_bytes=bwd_peak, opt_peak_bytes=opt_peak)

    rows = [step(i) for i in range(steps)]
    med = {k: statistics.median(r[k] for r in rows[1:]) for k in rows[0]}
    window = device_window(lambda: step(steps), 2,
                           share_of={"gemm": "gemm"})
    return dict(med, step_ms=med["fwd_ms"] + med["bwd_ms"] + med["opt_ms"],
                state_bytes=state_bytes,
                n_params=sum(v.numel() for v in params.values()),
                profiled=window)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--variants", default="f32,bf16,remat")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("lm_train_cost measures the card; torch sees no "
                           "CUDA device")
    from repro_torch.launch.profiling import card
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in args.variants.split(","):
        dtype, remat = VARIANTS[name]
        print(json.dumps(dict(
            card=card(), arch=args.arch, variant=name, batch=args.batch,
            seq=args.seq, **measure(args.arch, dtype, remat, args.batch,
                                    args.seq, args.steps))), flush=True)


if __name__ == "__main__":
    main()
