"""How far each package's bf16 LM lands from its own f32 LM on the same
weights, and how far the two packages' bf16 LMs land from each other, on
the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/lm_bf16_drift.py --reduced
    PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/lm_bf16_drift.py \\
        --d-model 256 --expert-d-ff 176 --d-ff 1368 --vocab 4096

Without `--reduced`, the arch's full config (deepseek-moe-16b by default:
28 layers, 64 routed experts top-6, 2 shared, layer 0 dense, head_dim
128) is narrowed to the widths given, so depth, expert count and routing
stay as published while the model fits a CPU (the flags above make ~250 M
params). The reference draws the weights from seed 0 (JAX `init`) and
`checkpoint.convert.params_from_jax` carries them to the port. Both
packages prefill the same prompts and take one decode step on the plain
path (use_kernels=False), in f32 and in bf16. Prints one JSON line: the
largest |logit| and |final residual| of the JAX f32 model, each model's
max abs logit distance from JAX f32, the port's bf16 from JAX's bf16, and
how many rows pick the JAX f32 argmax.
"""
import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.model import ModelOpts as JaxOpts
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.models.layers import embed_tokens
from repro_torch.models.model import ModelOpts, build_model


def configs(args):
    """(JAX config, port config) of the same shape."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = get(args.arch)
        if args.reduced:
            out.append(cfg.reduced())
            continue
        moe = dataclasses.replace(cfg.moe, d_ff=args.expert_d_ff)
        out.append(dataclasses.replace(
            cfg, d_model=args.d_model, n_heads=args.d_model // cfg.head_dim,
            n_kv_heads=args.d_model // cfg.head_dim, d_ff=args.d_ff,
            vocab=args.vocab, moe=moe))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-moe-16b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--expert-d-ff", type=int, default=176)
    ap.add_argument("--d-ff", type=int, default=1368)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    args = ap.parse_args(argv)
    jcfg, tcfg = configs(args)
    B, S = args.batch, args.prompt_len
    prompts = np.random.default_rng(1).integers(
        0, tcfg.vocab, (B, S)).astype(np.int32)
    jparams = None
    logits = {}
    for dt in ("float32", "bfloat16"):
        jm = jax_build_model(jcfg, JaxOpts(dtype=dt, remat=False))
        if jparams is None:
            jparams = jm.init(jax.random.PRNGKey(0))
            tparams = params_from_jax(
                jax.tree_util.tree_map(np.asarray, jparams))
        jl, jc = jax.jit(lambda p, t: jm.prefill(
            p, t, cache_capacity=S + 1))(jparams, jnp.asarray(prompts))
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        jd, _ = jax.jit(jm.decode_step)(jparams, jnp.asarray(tok), jc,
                                        jnp.int32(S))
        logits[("jax", dt)] = np.concatenate(
            [np.asarray(jl, np.float32), np.asarray(jd, np.float32)], 1)
        tm = build_model(tcfg, ModelOpts(dtype=dt))
        with torch.inference_mode():
            tl, tc = tm.prefill(tparams, torch.tensor(prompts), S + 1)
            td, _ = tm.decode_step(tparams, torch.tensor(tok), tc, S)
        logits[("port", dt)] = torch.cat([tl, td], 1).float().numpy()
        del jc, tc
    tm = build_model(tcfg, ModelOpts(dtype="float32"))
    with torch.inference_mode():
        x = embed_tokens({"tok": tparams["embed/tok"]},
                         torch.tensor(prompts).long(), tcfg, torch.float32)
        resid, _, _ = tm._run_seq(tparams, x)
    ref = logits[("jax", "float32")]
    out = {"arch": tcfg.name, "n_layers": tcfg.n_layers,
           "d_model": tcfg.d_model, "n_experts": tcfg.moe.n_experts
           if tcfg.moe else 0, "batch": B, "prompt_len": S,
           "max_abs_logit_jax_f32": float(np.abs(ref).max()),
           "max_abs_final_residual_f32": float(resid.abs().max())}
    for key, got in logits.items():
        out[f"{key[0]} {key[1]} vs jax f32"] = {
            "max_abs_err": float(np.abs(got - ref).max()),
            "argmax_equal": int((got.argmax(-1) == ref.argmax(-1)).sum()),
            "rows": int(ref.shape[0] * ref.shape[1])}
    out["port bf16 vs jax bf16 max_abs_err"] = float(np.abs(
        logits[("port", "bfloat16")] - logits[("jax", "bfloat16")]).max())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
