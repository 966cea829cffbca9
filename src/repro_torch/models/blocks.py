"""Per-layer block: token mixer (attention, local attention, MLA, RWKV-6
or Mamba) + channel mixer (dense SwiGLU, GELU MLP or MoE; RWKV's own
channel mix), pre-norm residual; whisper decoder blocks add
cross-attention. The port of src/repro/models/blocks.py, with one entry
point per execution mode (sequence: train and prefill; one-token
decode)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ATTN, ATTN_LOCAL, MAMBA, MLA, RWKV
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import (apply_mlp, apply_mlp_gelu, apply_norm,
                                       mlp_gelu_params, mlp_params,
                                       norm_params)


class Block(nn.Module):
    """Parameter template of one block (norm1, mixer, [xnorm, xattn],
    norm2, ffn, as the reference names them), indexable by name like the
    reference's param dicts. `forward` is `apply_block_seq`, or
    `apply_block_decode` when given a cache. An encoder block is built
    with `causal=False`."""

    def __init__(self, cfg, kind: str, is_moe: bool, opts: attn.AttnOpts,
                 has_cross: bool = False, gelu_mlp: bool = False,
                 causal: bool = True):
        super().__init__()
        self.cfg, self.kind, self.is_moe, self.opts = cfg, kind, is_moe, opts
        self.gelu_mlp, self.causal = gelu_mlp, causal
        self.norm1 = norm_params(cfg)
        if kind == RWKV:  # its channel-mix params live inside the mixer
            self.mixer = rwkv_mod.init_rwkv(cfg)
            self.norm2 = norm_params(cfg)
            return
        if kind == MAMBA:
            self.mixer = mamba_mod.mamba_params(cfg)
        elif kind in (ATTN, ATTN_LOCAL, MLA):
            self.mixer = attn.attn_params(cfg, kind)
        else:
            raise ValueError(kind)
        if has_cross:
            self.xnorm = norm_params(cfg)
            self.xattn = attn.init_cross_attn(cfg)
        self.norm2 = norm_params(cfg)
        if is_moe:
            self.ffn = moe_mod.init_moe(cfg)
        elif gelu_mlp:
            self.ffn = mlp_gelu_params(cfg)
        else:
            self.ffn = mlp_params(cfg)

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name):
        return name in self._modules

    def forward(self, x, pos0=0, cache_capacity=0, cache=None, pos=None,
                enc_out=None):
        if cache is not None:
            return apply_block_decode(self.cfg, self, self.kind, self.is_moe,
                                      x, cache, pos, self.opts,
                                      gelu_mlp=self.gelu_mlp)
        return apply_block_seq(self.cfg, self, self.kind, self.is_moe, x,
                               pos0, self.opts, cache_capacity=cache_capacity,
                               enc_out=enc_out, gelu_mlp=self.gelu_mlp,
                               causal=self.causal)


def init_block(cfg, kind: str, is_moe: bool, opts: attn.AttnOpts,
               has_cross: bool = False, gelu_mlp: bool = False,
               causal: bool = True) -> Block:
    return Block(cfg, kind, is_moe, opts, has_cross, gelu_mlp, causal)


def init_cache(cfg, kind: str, batch: int, capacity: int, dtype, device,
               has_cross: bool = False, enc_tokens: int = 0):
    """Zero cache entry for one layer: the KV cache of an attention block
    (a ring of min(capacity, window) slots for a local one), MLA's latent
    cache, the recurrent state of an RWKV block (S in f32 whatever
    `dtype`, and the two token-shift states) or of a Mamba block (the
    conv tail in `dtype`, the ssm state in f32), and with `has_cross` the
    encoder's cross keys and values."""
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if kind in (ATTN, ATTN_LOCAL):
        C = min(capacity, cfg.window) if kind == ATTN_LOCAL else capacity
        c = {"k": zeros(batch, C, KVH, D), "v": zeros(batch, C, KVH, D)}
    elif kind == MLA:
        c = {"ckv": zeros(batch, capacity, cfg.kv_lora_rank),
             "kr": zeros(batch, capacity, cfg.rope_head_dim)}
    elif kind == RWKV:
        c = {"S": zeros(batch, H, D, D, dt=torch.float32),
             "shift_tm": zeros(batch, cfg.d_model),
             "shift_cm": zeros(batch, cfg.d_model)}
    elif kind == MAMBA:
        di = cfg.ssm_expand * cfg.d_model
        c = {"conv": zeros(batch, cfg.ssm_conv - 1, di),
             "ssm": zeros(batch, di, cfg.ssm_state, dt=torch.float32)}
    else:
        raise ValueError(kind)
    if has_cross:
        c["ek"] = zeros(batch, enc_tokens, KVH, D)
        c["ev"] = zeros(batch, enc_tokens, KVH, D)
    return c


def cross_seq(cfg, p, h, enc_out, opts, pos0=0):
    """A decoder block's cross attention of its normed input h =
    xnorm(x) over the encoder's output -> (out, (ek, ev)), the encoder
    keys and values a prefill caches."""
    dt = enc_out.dtype
    ek = torch.einsum("btd,dhk->bthk", enc_out, p["xattn"]["wk"].to(dt))
    ev = torch.einsum("btd,dhk->bthk", enc_out, p["xattn"]["wv"].to(dt))
    out, _ = attn.gqa_seq(cfg, p["xattn"], h, pos0, ATTN, opts,
                          cross_kv=(ek, ev))
    return out, (ek, ev)


def mixer_seq(cfg, p, kind, h, pos0, opts, cache_capacity=0, causal=True,
              cache_in=None):
    """The token mixer of a non-RWKV block over normed input h ->
    (out, cache or None); a Mamba mixer starts from `cache_in` (zeros
    when None)."""
    if kind == MAMBA:
        st = cache_in or init_cache(cfg, MAMBA, h.shape[0], 0, h.dtype,
                                    h.device)
        o, new_st = mamba_mod.mamba_seq(cfg, p["mixer"], h, st)
        return o, new_st if cache_capacity else None
    if kind == MLA:
        return attn.mla_seq(cfg, p["mixer"], h, pos0, opts,
                            cache_capacity=cache_capacity)
    return attn.gqa_seq(cfg, p["mixer"], h, pos0, kind, opts,
                        cache_capacity=cache_capacity, causal=causal)


def ffn(cfg, p, is_moe, gelu_mlp, h, opts):
    """Channel mixer -> (out, aux); a dense FFN's aux is 0.0, a float, so
    a model without MoE layers launches nothing for it."""
    if is_moe:
        return moe_mod.apply_moe(cfg, p["ffn"], h,
                                 use_kernels=opts.use_kernels,
                                 local_dispatch=opts.moe_local)
    if gelu_mlp:
        return apply_mlp_gelu(p["ffn"], h), 0.0
    return apply_mlp(p["ffn"], h), 0.0


def _residual_norm(p, x, o):
    """(x + o, norm2(x + o)), where norm2 reads the sum in f32, unrounded,
    as the reference's compiled bf16 graph does (XLA drops the rounding of
    a bf16 add whose other use is a convert to f32); the carried residual
    is that sum rounded to x's dtype, which is the bf16 add. In f32 it is
    x + o either way."""
    xo = x.float() + o
    return xo.to(x.dtype), apply_norm(p["norm2"], xo).to(x.dtype)


def _norm1(p, x, opts):
    """(x in the model's dtype, norm1(x)): x may be the previous block's
    output sum in f32, unrounded, which norm1 reads as it is, as the
    reference's compiled graph does within a super-block
    (`_residual_norm`'s reason; models/model.py `_rounds_before`)."""
    return x.to(opts.dtype), apply_norm(p["norm1"], x).to(opts.dtype)


def _rwkv(cfg, p, x, st, chunk, opts):
    """An RWKV block from recurrent state `st` -> (x, new state); under
    `use_kernels` the kernel writes the new S over st["S"]."""
    x, h = _norm1(p, x, opts)
    o, tm = rwkv_mod.rwkv_time_mix_seq(
        cfg, p["mixer"], h, {"S": st["S"], "shift": st["shift_tm"]}, chunk,
        use_kernels=opts.use_kernels)
    x, h2 = _residual_norm(p, x, o)
    o2, shift_cm = rwkv_mod.rwkv_channel_mix(cfg, p["mixer"], h2,
                                             st["shift_cm"])
    return x.float() + o2, {"S": tm["S"], "shift_tm": tm["shift"],
                            "shift_cm": shift_cm}


def apply_block_seq(cfg, p, kind, is_moe, x, pos0, opts, *,
                    cache_capacity=0, enc_out=None, cache_in=None,
                    gelu_mlp=False, causal=True):
    """Train (cache_capacity=0) / prefill (>0) path: x + mixer(norm1(x)),
    then + xattn(xnorm(·)) against `enc_out` in a decoder block with
    cross-attention, then + ffn(norm2(·)). Returns (x, cache, aux_loss):
    x the output sum in f32, unrounded (the model rounds it to its dtype
    where the reference does, `_norm1`); the cache is {} in train mode
    and holds the cross keys and values `ek`, `ev` in a cross block. A
    recurrent block (RWKV, Mamba) starts from `cache_in`, zeros when
    None."""
    if kind == RWKV:
        st = cache_in or init_cache(cfg, RWKV, x.shape[0], 0, opts.dtype,
                                    x.device)
        x, cache = _rwkv(cfg, p, x, st, 64, opts)
        return x, cache if cache_capacity else {}, 0.0
    x, h = _norm1(p, x, opts)
    o, cache = mixer_seq(cfg, p, kind, h, pos0, opts, cache_capacity, causal,
                         cache_in)
    cache = cache or {}
    if enc_out is not None and "xattn" in p:
        x = x + o
        o, (ek, ev) = cross_seq(cfg, p, apply_norm(p["xnorm"], x), enc_out,
                                opts, pos0)
        if cache_capacity:
            cache.update(ek=ek, ev=ev)
    x, h2 = _residual_norm(p, x, o)
    o2, aux = ffn(cfg, p, is_moe, gelu_mlp, h2, opts)
    return x.float() + o2, cache, aux


def apply_block_decode(cfg, p, kind, is_moe, x, cache, pos, opts,
                       gelu_mlp=False):
    """One-token decode; writes into `cache` in place this token's k, v
    (attention), its latents (MLA) or the new recurrent state (RWKV: the
    time mix at chunk 1, under `use_kernels` the kernel writing S straight
    into the cache's buffer; Mamba: the scan at chunk 1). A cross block
    attends the cache's `ek`, `ev`. Returns (x, cache, aux), x in f32 as
    `apply_block_seq`'s."""
    if kind == RWKV:
        x, new = _rwkv(cfg, p, x, cache, 1, opts)
        for key, val in new.items():
            cache[key].copy_(val)  # a no-op for the S the kernel wrote
        return x, cache, 0.0
    x, h = _norm1(p, x, opts)
    if kind == MAMBA:
        o, st = mamba_mod.mamba_decode(cfg, p["mixer"], h, cache)
        for key, val in st.items():
            cache[key].copy_(val)
    elif kind == MLA:
        o = attn.mla_decode(cfg, p["mixer"], h, cache, pos, opts)
    else:
        o = attn.gqa_decode(cfg, p["mixer"], h, cache, pos, kind, opts)
    if "xattn" in p and "ek" in cache:
        x = x + o
        o = attn.gqa_decode(cfg, p["xattn"], apply_norm(p["xnorm"], x),
                            None, pos, ATTN, opts,
                            cross_kv=(cache["ek"], cache["ev"]))
    x, h2 = _residual_norm(p, x, o)
    o2, aux = ffn(cfg, p, is_moe, gelu_mlp, h2, opts)
    return x.float() + o2, cache, aux
