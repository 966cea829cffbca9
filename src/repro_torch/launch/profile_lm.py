"""Where an LM decode step and a prefill spend their time, on the card.

    python -m repro_torch.launch.profile_lm [--arch deepseek-moe-16b] [--plain]
    python -m repro_torch.launch.profile_lm --arch rwkv6-1.6b [--plain]
    python -m repro_torch.launch.profile_lm --arch whisper-base [--plain]

Builds the full-width model in bf16 with `use_kernels` (or without, with
`--plain`), draws its weights on the card from seed 0, and serves at the
shape of `chip_smoke.py`'s LM case: a batch of 4 prompts of 32 tokens
into a cache of 32 + 16 slots, as `serve()` sizes it for 16 new tokens;
the decode steps run at positions 32..47 (after a VLM's prefix; whisper
and paligemma get the stub frontend input of `serve()`). Any LM that fits
the card whole (jamba and llama4 do not). Reports, as one JSON line, for
the prefill and for a decode step:
  * `wall_ms`: host wall time per call, ending in a device sync;
  * `issue_ms`: host time to enqueue the call, without the sync;
  * a torch.profiler window (`launch/profiling.device_window`): the
    device's busy share, device time and device ops per call, the top
    kernels by device time, and the grouped-matmul and WKV kernels'
    shares.
Needs a card: there is no CPU mode.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.launch.profiling import card, device_window

BATCH, PROMPT_LEN, GEN_LEN = 4, 32, 16


def _timed(fn, n):
    """(host wall ms per call with a sync, host ms to enqueue n calls / n)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    issue = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, issue


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.profile_lm")
    ap.add_argument("--arch", default="deepseek-moe-16b")
    ap.add_argument("--plain", action="store_true",
                    help="use_kernels=False: the model's own einsums")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_lm measures the card; torch sees no "
                           "CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch.serve import stub_frontend
    from repro_torch.models.model import ModelOpts, build_model

    model = build_model(args.arch, ModelOpts(dtype="bfloat16", remat=False,
                                             use_kernels=not args.plain))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    B, S = BATCH, PROMPT_LEN
    prompts = torch.randint(0, model.cfg.vocab, (B, S), generator=gen,
                            device="cuda")
    tok = torch.zeros((B, 1), dtype=torch.long, device="cuda")
    fe = stub_frontend(model.cfg, B, "cuda")
    S0 = S + model.n_prefix
    with torch.inference_mode():
        def prefill():
            return model.prefill(params, prompts, S + GEN_LEN, frontend=fe)

        _, cache = prefill()  # warmup (and the kernel build)
        step = [0]

        def decode():
            model.decode_step(params, tok, cache, S0 + step[0] % GEN_LEN)
            step[0] += 1

        decode()
        out = {"card": card(), "arch": args.arch, "batch": B,
               "prompt_len": S, "cache_capacity": S + GEN_LEN,
               "use_kernels": not args.plain}
        for name, fn, k in (("prefill", prefill, 4),
                            ("decode", decode, GEN_LEN)):
            wall_ms, issue_ms = _timed(fn, k)
            out[name] = dict(wall_ms=wall_ms, issue_ms=issue_ms,
                             profile=device_window(
                                 fn, k, share_of={"gmm_ecd": "gmm_bf16_kernel",
                                                  "wkv6_btHN": "wkv6"}))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
