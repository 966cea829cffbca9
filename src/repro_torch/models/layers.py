"""Shared primitive layers: parameter templates and init, norms, RoPE,
SwiGLU and GELU MLPs, embeddings.

Parameters live as shape templates on the meta device inside
`nn.Module`s; their values are a flat dict of tensors named by the JAX
key path ("lm/stack/0/t0/mixer/wq"), made by `init_params` and handed to
the module through `apply_params` (torch.func.functional_call). So the
weights are inputs, and a hot swap changes only tensor contents.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call


# -- parameter templates ----------------------------------------------------

def dense_init(generator, shape, scale=None, dtype=torch.float32):
    """Truncated-normal (±2) fan-in init, drawn in f32 on `generator`'s
    device and stored in `dtype`: a seed gives the same weights on every
    device for a CPU generator, and a CUDA generator draws on the card."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(dtype)


def dense(scale=None, dtype=None):
    """A matrix leaf, stored in the model's dtype, or always in `dtype`
    when given (a leaf the reference reads in f32 whatever the model's)."""
    return lambda generator, shape, model_dtype: dense_init(
        generator, shape, scale, dtype or model_dtype)


def const(value):
    """A constant leaf (norm scales and biases, policy-head biases); it
    stays f32 whatever the storage dtype, as the reference uses it."""
    return lambda generator, shape, dtype: torch.full(
        shape, float(value), device=generator.device)


ones, zeros = const(1.0), const(0.0)


def normal(std):
    """A leaf drawn from N(0, std²) in f32, stored in the model's dtype
    (the whisper encoder's position table, which the reference casts to
    the model's dtype at use)."""
    def init(generator, shape, dtype):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return t.mul_(std).to(dtype)
    return init


def add_param(module: nn.Module, name: str, shape, init) -> None:
    """Register a meta-device template `name` of `shape` on `module`;
    `init(generator, shape, dtype)` makes its value in `init_params`."""
    module.register_parameter(name, nn.Parameter(
        torch.empty(tuple(shape), device="meta"), requires_grad=False))
    if "_inits" not in module.__dict__:
        module._inits = {}
    module._inits[name] = (tuple(shape), init)


class Params(nn.Module):
    """A leaf group of named parameter templates, e.g.
    `Params(w=((d, f), dense()), b=((f,), zeros))`. Indexable by name,
    like the reference's param dicts."""

    def __init__(self, **specs):
        super().__init__()
        for name, (shape, init) in specs.items():
            add_param(self, name, shape, init)

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name):
        return name in self._inits


def init_params(module: nn.Module, generator, device,
                dtype=torch.float32) -> dict:
    """Fresh values for every template under `module`, keyed by JAX key
    path, drawn in module order from `generator` on its device one leaf at
    a time, each stored at once in `dtype` (matrices; constant leaves stay
    f32) and moved to `device`. No f32 copy of the whole model is made."""
    out = {}
    for prefix, mod in module.named_modules():
        for name, (shape, init) in mod.__dict__.get("_inits", {}).items():
            key = f"{prefix}.{name}" if prefix else name
            out[key.replace(".", "/")] = init(generator, shape,
                                              dtype).to(device)
    return out


def apply_params(module: nn.Module, params: dict, *args, **kwargs):
    """Run `module(*args, **kwargs)` on the flat `params` (JAX key
    paths)."""
    named = {k.replace("/", "."): v for k, v in params.items()}
    return functional_call(module, named, args, kwargs, strict=True)


# -- norms ------------------------------------------------------------------

def norm_params(cfg) -> Params:
    if cfg.norm == "layernorm":
        return Params(scale=((cfg.d_model,), ones),
                      bias=((cfg.d_model,), zeros))
    return Params(scale=((cfg.d_model,), ones))


def apply_norm(params, x, eps=1e-6):
    xf = x.float()
    if "bias" in params:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"] + params["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"]
    return y.to(x.dtype)


# -- rotary embeddings ------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S). The
    half-split rotation [x1·cos − x2·sin, x2·cos + x1·sin]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    angles = angles[..., None, :]                           # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# -- activations ------------------------------------------------------------

def sigmoid(x):
    """jax.nn.sigmoid as the reference's compiled bf16 graph computes it,
    1 / (1 + e^{-x}) with each step rounded to x's dtype: torch.sigmoid
    rounds once, an ulp away on ~1/3 of bf16 inputs, which puts the bf16
    RWKV and Mamba models outside the bf16 parity bounds of
    tests/test_torch_rwkv.py and tests/test_torch_lm_serve.py
    (ROADMAP.md §3)."""
    return torch.reciprocal(torch.exp(-x) + 1)


def silu(x):
    """jax.nn.silu. In bf16 as the reference's compiled graph computes
    it, x · `sigmoid`(x), each step and the product rounded (torch's silu
    rounds once, an ulp away on many inputs, enough to flip a reduced
    MoE's router in tests/test_torch_lm_serve.py); in f32 torch's silu,
    so the f32 paths (the policy trunk's among them) keep their bits."""
    if x.dtype == torch.float32:
        return nn.functional.silu(x)
    return x * sigmoid(x)


# -- MLP --------------------------------------------------------------------

def mlp_params(cfg, d_ff=None) -> Params:
    d_ff = d_ff or cfg.d_ff
    return Params(wi=((cfg.d_model, d_ff), dense()),
                  wg=((cfg.d_model, d_ff), dense()),
                  wo=((d_ff, cfg.d_model), dense()))


def apply_mlp(params, x):
    """SwiGLU."""
    h = torch.einsum("...d,df->...f", x, params["wi"].to(x.dtype))
    g = torch.einsum("...d,df->...f", x, params["wg"].to(x.dtype))
    h = silu(g) * h
    return torch.einsum("...f,fd->...d", h, params["wo"].to(x.dtype))


def mlp_gelu_params(cfg, d_ff=None) -> Params:
    """2-matrix GELU MLP (whisper-style)."""
    d_ff = d_ff or cfg.d_ff
    return Params(wi=((cfg.d_model, d_ff), dense()),
                  wo=((d_ff, cfg.d_model), dense()))


def apply_mlp_gelu(params, x):
    """GELU in its tanh form, which is `jax.nn.gelu`'s default."""
    h = torch.einsum("...d,df->...f", x, params["wi"].to(x.dtype))
    return torch.einsum("...f,fd->...d",
                        nn.functional.gelu(h, approximate="tanh"),
                        params["wo"].to(x.dtype))


# -- embeddings -------------------------------------------------------------

def embed_params(cfg) -> Params:
    specs = {"tok": ((cfg.vocab, cfg.d_model), dense(cfg.d_model ** -0.5))}
    if not cfg.tie_embeddings:
        specs["unembed"] = ((cfg.d_model, cfg.vocab), dense())
    return Params(**specs)


def embed_tokens(params, tokens, cfg, dtype):
    x = params["tok"][tokens].to(dtype)
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return x


def unembed(params, x, cfg):
    if cfg.tie_embeddings:
        w = params["tok"].to(x.dtype).T
    else:
        w = params["unembed"].to(x.dtype)
    return torch.einsum("...d,dv->...v", x, w)
