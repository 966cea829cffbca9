"""Serving launchers (actor side) — two traffic surfaces, one module (the
port of src/repro/launch/serve.py):

  * **LM stub** (default): prefill a batch of prompts, then step the
    decoder with a KV cache — the survey's SEED-style centralized
    inference path. A warmup prefill + decode runs first (reported as
    `warmup_s`; on the card it includes building the CUDA kernels), so
    `prefill_s` and `decode_tok_per_s` are steady-state numbers.

  * **Policy serving** (`policy` subcommand): forwards to
    repro_torch.launch.serve_policy.

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --reduced --device cpu --use-kernels
  python -m repro_torch.launch.serve --arch deepseek-moe-16b \\
      --dtype bfloat16 --use-kernels          # full width, on the card
  python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --dtype bfloat16 --use-kernels          # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve policy --device cpu \\
      --quick

`--use-kernels` (the reference's `ModelOpts.use_kernels`) runs the
prefill's attention in the flash-attention kernel, the MoE expert
matmuls in the grouped-matmul kernel and RWKV-6's time mix (prefill and
every decode step) in the chunked-WKV kernel on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import ModelOpts, build_model


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _next_token(logits, temperature, generator):
    """Greedy at temperature 0, else a Gumbel-max draw from
    softmax(logits / temperature) with noise from `generator`."""
    last = logits[:, -1].float()
    if temperature > 0:
        u = torch.rand(last.shape, generator=generator, device=last.device)
        tiny = torch.finfo(torch.float32).tiny
        last = last / temperature - torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(last, dim=-1)[:, None]


def generate(model, params, prompts, gen_len, temperature=0.0,
             generator=None):
    """Prefill `prompts` (B, S) into a cache of S + gen_len slots, then
    decode gen_len tokens. Returns {"tokens": (B, gen_len), "prefill_s",
    "decode_s"} (host clock, each ending in a device sync)."""
    device = prompts.device
    S = prompts.shape[1]
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompts, S + gen_len)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        tok = _next_token(logits, temperature, generator)
        tokens = []
        t0 = time.perf_counter()
        for i in range(gen_len):
            logits, cache = model.decode_step(params, tok, cache, S + i)
            tok = _next_token(logits, temperature, generator)
            tokens.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(tokens, dim=1), "prefill_s": t_prefill,
            "decode_s": t_decode}


def serve(arch="smollm-360m", reduced=True, batch=4, prompt_len=32,
          gen_len=16, temperature=1.0, seed=0, dtype="float32", *,
          device="cuda", use_kernels=False, params=None, prompts=None):
    """The reference's LM serving benchmark. Params are drawn from seed
    `seed` on `device` unless given; prompts are drawn from the same
    generator unless given as (batch, prompt_len) tokens. Returns the
    reference's keys (times unrounded) and the device."""
    device = resolve_device(device)
    model = build_model(arch, ModelOpts(dtype=dtype, use_kernels=use_kernels),
                        reduced=reduced)
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.inference_mode():
        if params is None:
            params = model.init(gen, device)
        if prompts is None:
            prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                                    generator=gen, device=device)
        # warmup: a prefill and one decode step before anything is timed
        t0 = time.perf_counter()
        logits_w, cache_w = model.prefill(params, prompts,
                                          prompt_len + gen_len)
        model.decode_step(params, _next_token(logits_w, 0.0, None), cache_w,
                          prompt_len)
        _sync(device)
        t_warmup = time.perf_counter() - t0
        del logits_w, cache_w
    run = generate(model, params, prompts, gen_len, temperature, gen)
    out = run["tokens"]
    return {"arch": arch, "batch": batch,
            "warmup_s": t_warmup,
            "prefill_s": run["prefill_s"],
            "decode_tok_per_s": batch * gen_len / run["decode_s"],
            "generated_shape": list(out.shape),
            "sample": out[0, :8].tolist(),
            "device": str(device)}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "policy":
        # bucketed micro-batching policy serving lives in its own
        # launcher; this is the one front door for both surfaces
        from repro_torch.launch.serve_policy import main as policy_main
        return policy_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="LM-stub serving benchmark; use the `policy` "
                    "subcommand for batched policy serving "
                    "(repro_torch.launch.serve_policy).")
    ap.add_argument("--arch", default="smollm-360m",
                    help="smollm-360m, deepseek-moe-16b or rwkv6-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--use-kernels", action="store_true",
                    help="flash attention, grouped matmul and chunked WKV "
                         "kernels on the card")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(serve(args.arch, args.reduced, args.batch,
                           args.prompt_len, args.gen_len, dtype=args.dtype,
                           device=args.device,
                           use_kernels=args.use_kernels)))


if __name__ == "__main__":
    main()
