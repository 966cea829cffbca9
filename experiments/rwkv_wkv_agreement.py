"""Where the full-width rwkv6-1.6b's f32 kernel path and its plain path
part, on the card: layer by layer through the model, and for each
layer's WKV against a float64 per-step scan on the same inputs.

    python experiments/rwkv_wkv_agreement.py [--prompt-len 32] [--layers 24]

The weights are drawn on the card from seed 0 in bf16 and their
constants redrawn as `chip_smoke.py` redraws them (`perturb_rwkv`); the
model computes in f32 (each bf16 weight cast at use). Each layer's block
runs three ways: on the kernel path's own activations, on the plain
path's own activations (so the two drift apart end to end), and the
kernel block on the plain path's input (the per-layer difference); and
a second plain order, the plain path with its WKV in the f32 per-step
scan instead of the chunked one, on its own activations, so that the
kernel path's end-to-end drift can be read against the drift between two
f32 orders of the plain path. For
each layer's time mix, the WKV of the plain path's input runs in the
kernel (`wkv6_btHN`), in the model's chunked WKV (`wkv_chunked`) and in
the per-step scan in f32 (`wkv6_ref`), each held against the per-step
scan in float64: max |y - y64| / max |y64| and the same for S, and the
kernel's error over `wkv_chunked`'s (`kernel_over_chunked_y`, `_S`; the
summary's `worst_y_rel` holds their largest over the layers). Prints
one JSON line per layer and a summary line; needs a card.
`--no-perturb` keeps the reference's init constants.
"""
import argparse
import contextlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (perturb_rwkv, the chip phase's redraw)
from repro_torch.kernels.wkv6.kernel import wkv6_btHN  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_ref  # noqa: E402
from repro_torch.launch.profiling import card  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models.layers import (apply_norm, apply_params,  # noqa: E402
                                       embed_tokens)
from repro_torch.models.model import ModelOpts, build_model  # noqa: E402


def rel(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max().clamp_min(1e-300)).item()


@contextlib.contextmanager
def per_step_wkv():
    """The plain path with its WKV computed by the per-step scan."""
    chunked = rwkv6.wkv_chunked
    rwkv6.wkv_chunked = lambda r, k, v, logw, u, S, chunk=64: wkv6_ref(
        r, k, v, logw, u, S)
    try:
        yield
    finally:
        rwkv6.wkv_chunked = chunked


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--no-perturb", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("this experiment measures the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = build_model("rwkv6-1.6b", ModelOpts(dtype="bfloat16"))
    cfg = base.cfg
    params = base.init(torch.Generator(device="cuda").manual_seed(0))
    if not args.no_perturb:
        chip_smoke.perturb_rwkv(params)
    mk = build_model(cfg, ModelOpts(dtype="float32", use_kernels=True))
    mp = build_model(cfg, ModelOpts(dtype="float32", use_kernels=False))
    kblocks = dict(mk.layers())
    toks = torch.randint(0, cfg.vocab, (4, args.prompt_len), device="cuda",
                         generator=torch.Generator(
                             device="cuda").manual_seed(1))
    worst = {}
    with torch.inference_mode():
        xk = xp = xq = embed_tokens({"tok": params["embed/tok"]}, toks,
                                    cfg, torch.float32)
        for i, (name, blk) in enumerate(mp.layers()):
            if i == args.layers:
                break
            sub = {k[len(name) + 1:]: v for k, v in params.items()
                   if k.startswith(name + "/")}
            mixer = {k[len("mixer/"):]: v for k, v in sub.items()
                     if k.startswith("mixer/")}
            h = apply_norm({"scale": sub["norm1/scale"],
                            "bias": sub["norm1/bias"]}, xp)
            prev, _ = rwkv6._token_shift(h, torch.zeros_like(h[:, 0]))
            r, k, v, _, logw = rwkv6._rkvwg(cfg, mixer, h, prev)
            r, k, v = r.float(), k.float(), v.float()
            u = mixer["u"].float()
            S0 = torch.zeros(r.shape[0], cfg.n_heads, cfg.head_dim,
                             cfg.head_dim, device="cuda")
            y64, S64 = wkv6_ref(*(t.double() for t in (r, k, v, logw, u)),
                                S0.double())
            wkv = {"kernel": wkv6_btHN(r, k, v, logw, u, S0.clone()),
                   "wkv_chunked": rwkv6.wkv_chunked(r, k, v, logw, u, S0),
                   "wkv6_ref_f32": wkv6_ref(r, k, v, logw, u, S0)}
            same = apply_params(kblocks[name], sub, xp, 0, 0)[0]
            xk = apply_params(kblocks[name], sub, xk, 0, 0)[0]
            with per_step_wkv():
                xq = apply_params(blk, sub, xq, 0, 0)[0]
            xp = apply_params(blk, sub, xp, 0, 0)[0]
            row = {"layer": name, "max_abs_x": xp.abs().max().item(),
                   "end_to_end_rel": rel(xk, xp),
                   "plain_orders_end_to_end_rel": rel(xq, xp),
                   "same_input_rel": rel(same, xp),
                   "logw_min": logw.min().item(),
                   "max_abs_y64": y64.abs().max().item()}
            for key, (y, S) in wkv.items():
                row[f"{key}_y_rel"] = rel(y, y64)
                row[f"{key}_S_rel"] = rel(S, S64)
                worst[key] = max(worst.get(key, 0.0), row[f"{key}_y_rel"])
            for part in ("y", "S"):  # the kernel's error over the model's
                ratio = (row[f"kernel_{part}_rel"]
                         / max(row[f"wkv_chunked_{part}_rel"], 1e-300))
                row[f"kernel_over_chunked_{part}"] = ratio
                worst[f"kernel_over_chunked_{part}"] = max(
                    worst.get(f"kernel_over_chunked_{part}", 0.0), ratio)
            print(json.dumps(row))
    print(json.dumps({"prompt_len": args.prompt_len,
                      "perturbed": not args.no_perturb,
                      "end_to_end_rel": row["end_to_end_rel"],
                      "plain_orders_end_to_end_rel":
                          row["plain_orders_end_to_end_rel"],
                      "worst_y_rel": worst, "card": card()}))


if __name__ == "__main__":
    main()
