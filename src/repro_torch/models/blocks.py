"""Per-layer block: GQA token mixer + channel mixer (dense SwiGLU or
MoE), pre-norm residual — the ATTN case of src/repro/models/blocks.py,
with one entry point per execution mode (sequence: train and prefill;
one-token decode)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ATTN
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, mlp_params,
                                       norm_params)


class Block(nn.Module):
    """Parameter template of one block (norm1, mixer, norm2, ffn, as the
    reference names them). `forward` is `apply_block_seq`, or
    `apply_block_decode` when given a cache."""

    def __init__(self, cfg, kind: str, is_moe: bool, opts: attn.AttnOpts):
        super().__init__()
        if kind != ATTN:
            raise attn._not_ported(f"block kind {kind!r}")
        self.cfg, self.kind, self.is_moe, self.opts = cfg, kind, is_moe, opts
        self.norm1 = norm_params(cfg)
        self.mixer = attn.attn_params(cfg, kind)
        self.norm2 = norm_params(cfg)
        self.ffn = moe_mod.init_moe(cfg) if is_moe else mlp_params(cfg)

    def forward(self, x, pos0=0, cache_capacity=0, cache=None, pos=None):
        if cache is not None:
            return apply_block_decode(self.cfg, self, self.kind, self.is_moe,
                                      x, cache, pos, self.opts)
        return apply_block_seq(self.cfg, self, self.kind, self.is_moe, x,
                               pos0, self.opts,
                               cache_capacity=cache_capacity)


def init_block(cfg, kind: str, is_moe: bool, opts: attn.AttnOpts) -> Block:
    return Block(cfg, kind, is_moe, opts)


def init_cache(cfg, kind: str, batch: int, capacity: int, dtype, device):
    """Zero cache entry for one layer."""
    if kind != ATTN:
        raise attn._not_ported(f"cache of kind {kind!r}")
    shape = (batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ffn(cfg, p, is_moe, h, opts):
    """Channel mixer -> (out, aux); a dense FFN's aux is 0.0, a float, so
    a model without MoE layers launches nothing for it."""
    if is_moe:
        return moe_mod.apply_moe(cfg, p.ffn, h, use_kernels=opts.use_kernels,
                                 local_dispatch=opts.moe_local)
    return apply_mlp(p.ffn, h), 0.0


def apply_block_seq(cfg, p, kind, is_moe, x, pos0, opts, *,
                    cache_capacity=0):
    """Train (cache_capacity=0) / prefill (>0) path: x + mixer(norm1(x)),
    then + ffn(norm2(·)). Returns (x, cache, aux_loss); the cache is {}
    in train mode."""
    h = apply_norm(p.norm1, x)
    o, cache = attn.gqa_seq(cfg, p.mixer, h, pos0, kind, opts,
                            cache_capacity=cache_capacity)
    x = x + o
    o2, aux = _ffn(cfg, p, is_moe, apply_norm(p.norm2, x), opts)
    return x + o2, cache or {}, aux


def apply_block_decode(cfg, p, kind, is_moe, x, cache, pos, opts):
    """One-token decode; writes this token's k, v into `cache` in place.
    Returns (x, cache, aux)."""
    h = apply_norm(p.norm1, x)
    x = x + attn.gqa_decode(cfg, p.mixer, h, cache, pos, kind, opts)
    o2, aux = _ffn(cfg, p, is_moe, apply_norm(p.norm2, x), opts)
    return x + o2, cache, aux
