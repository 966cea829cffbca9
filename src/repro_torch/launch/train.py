"""End-to-end LM training driver (the port of src/repro/launch/train.py:
the learner side of the survey's actor/learner split).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --steps 200 --batch 16 --seq 128 --device cpu
  python -m repro_torch.launch.train --steps 20      # full width, the card

Each step draws its batch from the counter-based `TokenStream`, takes
the gradient of `LanguageModel.loss` (next-token CE in f32 plus the MoE
aux loss) and applies `clip_by_global_norm(adamw(cosine_schedule(lr,
steps, warmup=steps // 20)), 1.0)`. The params are f32 master weights
whatever `dtype` (the compute dtype), as the reference keeps them, and
the optimizer replaces them a group of leaves at a time
(`Optimizer.apply_leafwise`), so a step's peak holds one copy of the
params and moments. The model runs with `use_kernels=False`, as the
reference's training does: its kernels have no backward (the flash,
grouped-matmul and WKV wrappers raise under grad on the card). whisper
and paligemma train on the reference's stub frontend
(`launch/serve.stub_frontend`).

Prints {"step", "ce", "elapsed_s"} every `log_every` steps and at the
last, then (CLI) the result without its history; `--ckpt` writes the
params in the reference's archive layout (`params/...`, super-blocks
stacked), which `repro.checkpoint.load_checkpoint` restores.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.core.agent import value_and_grad
from repro_torch.data import TokenStream
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.serve import stub_frontend
from repro_torch.models.model import ModelOpts, build_model
from repro_torch.optim import adamw, clip_by_global_norm, cosine_schedule


def make_train_step(model, optimizer):
    """One step on explicit state: the loss's gradient, then the
    optimizer, a group of leaves at a time on the `params` and
    `opt_state` dicts (which it updates in place). Returns (params,
    opt_state, loss, metrics)."""
    def step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(model.loss, params, batch,
                                                has_aux=True)
        optimizer.apply_leafwise(params, opt_state, grads)
        return params, opt_state, loss, {k: v.detach()
                                         for k, v in metrics.items()}
    return step


def train(arch="smollm-360m", reduced=True, steps=200, batch=16, seq=128,
          lr=3e-4, seed=0, ckpt=None, log_every=10, dtype="float32",
          remat=False, *, device="cuda", return_state=False):
    """The reference's `train`, on `device` (the card by default;
    RuntimeError without one). Params are drawn from seed `seed` on the
    device in f32. Returns {"arch", "n_params", "optimal_ce", "history",
    "device"}, its numbers unrounded (the reference rounds ce, elapsed_s
    and optimal_ce); with `return_state` also the final "params" and
    "opt_state"."""
    device = resolve_device(device)
    model = build_model(arch, ModelOpts(dtype=dtype, remat=remat),
                        reduced=reduced)
    cfg = model.cfg
    stream = TokenStream(cfg.vocab, seq, batch, seed=seed)
    optimizer = clip_by_global_norm(
        adamw(cosine_schedule(lr, steps, warmup=steps // 20)), 1.0)
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device, param_dtype=torch.float32)
    n_params = sum(v.numel() for v in params.values())
    opt_state = optimizer.init(params)
    step_fn = make_train_step(model, optimizer)
    fe = stub_frontend(cfg, batch, device)
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        b = stream.batch_at(i, device)
        if fe is not None:
            b["frontend"] = fe
        params, opt_state, _, metrics = step_fn(params, opt_state, b)
        if i % log_every == 0 or i == steps - 1:
            ce = float(metrics["ce"])
            history.append({"step": i, "ce": ce,
                            "elapsed_s": time.perf_counter() - t0})
            print(json.dumps(history[-1]))
    if ckpt:
        save_checkpoint(ckpt, {f"params/{k}": v for k, v in params.items()},
                        step=steps)
    out = {"arch": arch, "n_params": int(n_params),
           "optimal_ce": stream.optimal_ce(),
           "history": history, "device": str(device)}
    if return_state:
        out.update(params=params, opt_state=opt_state)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train",
                                 description="LM training (PyTorch port).")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    out = train(args.arch, args.reduced, args.steps, args.batch, args.seq,
                args.lr, ckpt=args.ckpt, device=args.device)
    print(json.dumps({k: v for k, v in out.items() if k != "history"}))


if __name__ == "__main__":
    main()
