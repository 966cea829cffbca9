"""Per-layer block: token mixer (GQA attention or RWKV-6) + channel mixer
(dense SwiGLU or MoE; RWKV's own channel mix), pre-norm residual — the
ATTN and RWKV cases of src/repro/models/blocks.py, with one entry point
per execution mode (sequence: train and prefill; one-token decode)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ATTN, RWKV
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, mlp_params,
                                       norm_params)


class Block(nn.Module):
    """Parameter template of one block (norm1, mixer, norm2, ffn, as the
    reference names them). `forward` is `apply_block_seq`, or
    `apply_block_decode` when given a cache."""

    def __init__(self, cfg, kind: str, is_moe: bool, opts: attn.AttnOpts):
        super().__init__()
        if kind not in (ATTN, RWKV):
            raise attn._not_ported(f"block kind {kind!r}")
        self.cfg, self.kind, self.is_moe, self.opts = cfg, kind, is_moe, opts
        self.norm1 = norm_params(cfg)
        if kind == RWKV:  # its channel-mix params live inside the mixer
            self.mixer = rwkv_mod.init_rwkv(cfg)
            self.norm2 = norm_params(cfg)
            return
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
    """Zero cache entry for one layer: the KV cache of an ATTN block, the
    recurrent state of an RWKV block (S in f32 whatever `dtype`, as the
    reference keeps it, and the two token-shift states)."""
    if kind == RWKV:
        H, D = cfg.n_heads, cfg.head_dim
        return {"S": torch.zeros((batch, H, D, D), dtype=torch.float32,
                                 device=device),
                "shift_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                        device=device),
                "shift_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                        device=device)}
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


def _rwkv(cfg, p, x, st, chunk, opts):
    """An RWKV block from recurrent state `st` -> (x, new state); under
    `use_kernels` the kernel writes the new S over st["S"].

    norm2 reads the residual sum x + o in f32, unrounded, as the
    reference's compiled bf16 graph does (XLA drops the rounding of a
    bf16 add whose other use is a convert to f32); the carried residual
    is that sum rounded to x's dtype, which is the bf16 add."""
    o, tm = rwkv_mod.rwkv_time_mix_seq(
        cfg, p.mixer, apply_norm(p.norm1, x),
        {"S": st["S"], "shift": st["shift_tm"]}, chunk,
        use_kernels=opts.use_kernels)
    xo = x.float() + o
    h2 = apply_norm(p.norm2, xo).to(x.dtype)
    x = xo.to(x.dtype)
    o2, shift_cm = rwkv_mod.rwkv_channel_mix(cfg, p.mixer, h2,
                                             st["shift_cm"])
    return x + o2, {"S": tm["S"], "shift_tm": tm["shift"],
                    "shift_cm": shift_cm}


def apply_block_seq(cfg, p, kind, is_moe, x, pos0, opts, *,
                    cache_capacity=0):
    """Train (cache_capacity=0) / prefill (>0) path: x + mixer(norm1(x)),
    then + ffn(norm2(·)). Returns (x, cache, aux_loss); the cache is {}
    in train mode. An RWKV block starts from a zero state."""
    if kind == RWKV:
        st = init_cache(cfg, RWKV, x.shape[0], 0, x.dtype, x.device)
        x, cache = _rwkv(cfg, p, x, st, 64, opts)
        return x, cache if cache_capacity else {}, 0.0
    h = apply_norm(p.norm1, x)
    o, cache = attn.gqa_seq(cfg, p.mixer, h, pos0, kind, opts,
                            cache_capacity=cache_capacity)
    x = x + o
    o2, aux = _ffn(cfg, p, is_moe, apply_norm(p.norm2, x), opts)
    return x + o2, cache or {}, aux


def apply_block_decode(cfg, p, kind, is_moe, x, cache, pos, opts):
    """One-token decode; writes this token's k, v (ATTN) or the new
    recurrent state (RWKV: the time mix at chunk 1; under `use_kernels`
    the kernel writes S straight into the cache's buffer) into `cache` in
    place. Returns (x, cache, aux)."""
    if kind == RWKV:
        x, new = _rwkv(cfg, p, x, cache, 1, opts)
        for key, val in new.items():
            cache[key].copy_(val)  # a no-op for the S the kernel wrote
        return x, cache, 0.0
    h = apply_norm(p.norm1, x)
    x = x + attn.gqa_decode(cfg, p.mixer, h, cache, pos, kind, opts)
    o2, aux = _ffn(cfg, p, is_moe, apply_norm(p.norm2, x), opts)
    return x + o2, cache, aux
