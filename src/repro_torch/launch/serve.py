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
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
      --reduced --device cpu --use-kernels
  python -m repro_torch.launch.serve --arch gemma3-1b \\
      --dtype bfloat16 --use-kernels          # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve policy --device cpu \\
      --quick

`--arch` takes any of the ten LMs of `repro_torch.configs.list_archs()`
(all but the policy trunk). jamba-v0.1-52b (~103 GB in bf16) and
llama4-maverick-400b-a17b (~795 GB) do not fit one 80 GB card whole;
`serve()` takes a `ModelConfig` with fewer layers in place of a name
(chip_smoke.py serves 8 and 2 of their layers).

`--trace-out PATH` prefills the prompts once more after the timed run,
under the profiler, and takes the first token: that prefill's Chrome
trace goes to PATH and the program's counters (the MoE experts' load)
beside it (`repro_torch.tracing.record`).

`--use-kernels` (the reference's `ModelOpts.use_kernels`) runs the
prefill's causal full attention (ATTN layers) in the flash-attention
kernel, the MoE expert matmuls in the grouped-matmul kernel and RWKV-6's
time mix (prefill and every decode step) in the chunked-WKV kernel on
the card. Local attention, MLA, the whisper encoder and cross attention,
Mamba and row-local MoE dispatch run on the model's own path either way,
as in the reference.

Configs with a frontend are served on the reference's stub input
(`stub_frontend`): 0.02 everywhere, of shape (B, frontend_tokens,
frontend_dim) for the vision prefix, (B, enc_tokens, d_model) for the
audio frames.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import ModelOpts, build_model
from repro_torch.tracing import record, spanned


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@spanned("repro_torch.lm.sample")
def _next_token(logits, temperature, generator):
    """Greedy at temperature 0, else a Gumbel-max draw from
    softmax(logits / temperature) with noise from `generator`."""
    last = logits[:, -1].float()
    if temperature > 0:
        u = torch.rand(last.shape, generator=generator, device=last.device)
        tiny = torch.finfo(torch.float32).tiny
        last = last / temperature - torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(last, dim=-1)[:, None]


def stub_frontend(cfg, batch, device):
    """The reference's stub frontend input of `cfg`, or None: 0.02 ×
    ones, (B, frontend_tokens, frontend_dim or d_model) patch embeddings
    for the vision stub, (B, enc_tokens, d_model) frames for the audio
    stub."""
    if cfg.frontend == "vision_stub":
        shape = (batch, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model)
    elif cfg.frontend == "audio_stub":
        shape = (batch, cfg.enc_tokens, cfg.d_model)
    else:
        return None
    return torch.full(shape, 0.02, device=device)


def generate(model, params, prompts, gen_len, temperature=0.0,
             generator=None, frontend=None):
    """Prefill `prompts` (B, S) (with the model's `frontend` input) into a
    cache of S + gen_len slots (and a VLM's prefix), then decode gen_len
    tokens at positions S + n_prefix + i. Returns {"tokens": (B,
    gen_len), "prefill_s", "decode_s"} (host clock, each ending in a
    device sync)."""
    device = prompts.device
    S = prompts.shape[1]
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompts, S + gen_len,
                                      frontend=frontend)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        tok = _next_token(logits, temperature, generator)
        tokens = []
        t0 = time.perf_counter()
        for i in range(gen_len):
            logits, cache = model.decode_step(params, tok, cache,
                                              S + model.n_prefix + i)
            tok = _next_token(logits, temperature, generator)
            tokens.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(tokens, dim=1), "prefill_s": t_prefill,
            "decode_s": t_decode}


def serve(arch="smollm-360m", reduced=True, batch=4, prompt_len=32,
          gen_len=16, temperature=1.0, seed=0, dtype="float32", *,
          device="cuda", use_kernels=False, params=None, prompts=None,
          trace_out=None):
    """The reference's LM serving benchmark. `arch` is a config name or a
    `ModelConfig`. Params are drawn from seed `seed` on `device` unless
    given; prompts are drawn from the same generator unless given as
    (batch, prompt_len) tokens; a config with a frontend gets the stub
    input. Returns the reference's keys (times unrounded) and the
    device. With `trace_out` (a path), one more prefill and its first
    token run after the timed run under `tracing.record(trace_out)`."""
    device = resolve_device(device)
    model = build_model(arch, ModelOpts(dtype=dtype, remat=False,
                                        use_kernels=use_kernels),
                        reduced=reduced)
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.inference_mode():
        if params is None:
            params = model.init(gen, device)
        if prompts is None:
            prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                                    generator=gen, device=device)
        fe = stub_frontend(cfg, batch, device)
        # warmup: a prefill and one decode step before anything is timed
        t0 = time.perf_counter()
        logits_w, cache_w = model.prefill(params, prompts,
                                          prompt_len + gen_len, frontend=fe)
        model.decode_step(params, _next_token(logits_w, 0.0, None), cache_w,
                          prompt_len + model.n_prefix)
        _sync(device)
        t_warmup = time.perf_counter() - t0
        del logits_w, cache_w
    run = generate(model, params, prompts, gen_len, temperature, gen, fe)
    out = run["tokens"]
    if trace_out is not None:
        with torch.inference_mode(), record(trace_out):
            logits, _ = model.prefill(params, prompts, prompt_len + gen_len,
                                      frontend=fe)
            _next_token(logits, temperature, gen)
    return {"arch": cfg.name, "batch": batch,
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
                    help="deepseek-moe-16b, gemma3-1b, jamba-v0.1-52b, "
                         "llama4-maverick-400b-a17b, minicpm3-4b, "
                         "paligemma-3b, rwkv6-1.6b, smollm-360m, "
                         "stablelm-1.6b or whisper-base")
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
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace of one more prefill to PATH "
                         "and the program's counters beside it")
    args = ap.parse_args(argv)
    print(json.dumps(serve(args.arch, args.reduced, args.batch,
                           args.prompt_len, args.gen_len, dtype=args.dtype,
                           device=args.device,
                           use_kernels=args.use_kernels,
                           trace_out=args.trace_out)))


if __name__ == "__main__":
    main()
