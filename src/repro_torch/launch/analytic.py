"""Analytic FLOP/byte cost model for the roofline terms (the port of
src/repro/launch/analytic.py, the same closed forms).

WHY ANALYTIC: the reference's XLA `cost_analysis()` counts a while-loop
body once, and the reference lowers layers, flash-attention kv blocks
and SSM chunks as scans, so its HLO flops and bytes undercount by the
trip counts. The compute and memory roofline terms below are exact
closed forms per architecture, read only from `ModelConfig` and
`ShapeConfig`; the port's dry-run records a FLOP count of the local
shards beside them as a cross-check (launch/dryrun.py), and its
collective term is counted op by op.

All counts are GLOBAL (whole step, all chips); dryrun divides by chips.
"""
from __future__ import annotations

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, MLA, RWKV, MAMBA,
                                ModelConfig, ShapeConfig)

WKV_CHUNK = 64
MAMBA_CHUNK = 32


def _attn_flops_token(cfg, ctx):
    """Per-token flops of one GQA layer at average context `ctx`."""
    H, KVH, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    proj = 2 * d * H * hd * 2 + 2 * d * KVH * hd * 2   # q,o + k,v
    attn = 2 * ctx * H * hd * 2                        # qk^T + pv
    return proj + attn


def _mla_flops_token(cfg, ctx, decode=False):
    H, hd, hr = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    d, rq, rkv = cfg.d_model, cfg.q_lora_rank or cfg.d_model, \
        cfg.kv_lora_rank
    proj = 2 * d * rq + 2 * rq * H * (hd + hr) \
        + 2 * d * (rkv + hr) + 2 * H * hd * d          # down/up q, dkv, o
    if decode:  # absorbed form: score vs latent cache
        absorb = 2 * H * hd * rkv * 2                  # q absorb + v expand
        attn = 2 * ctx * H * (rkv + hr) * 2
        return proj + absorb + attn
    expand = 2 * rkv * H * hd * 2                      # k_nope, v expand
    attn = 2 * ctx * H * (hd + hr) + 2 * ctx * H * hd
    return proj + expand + attn


def _rwkv_flops_token(cfg):
    d, H, N = cfg.d_model, cfg.n_heads, cfg.head_dim
    L = WKV_CHUNK
    proj = 2 * d * d * 5 + 2 * d * (5 * 32) * 2 + 2 * d * 64 * 2
    wkv = H * (8 * L * N + 6 * N * N)  # intra decay/score/pv + inter/state
    cm = 2 * d * cfg.d_ff * 2 + 2 * d * d              # channel mix
    return proj + wkv + cm


def _mamba_flops_token(cfg):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    proj = 2 * d * 2 * di + 2 * di * d
    conv = 2 * cfg.ssm_conv * di
    bc = 2 * di * 2 * N + 2 * di
    scan = 10 * di * N                                 # assoc-scan + y
    return proj + conv + bc + scan


def _ffn_flops_token(cfg, layer_idx):
    d = cfg.d_model
    if cfg.is_moe_layer(layer_idx):
        m = cfg.moe
        return (6 * d * m.d_ff * (m.top_k + m.n_shared)
                + 2 * d * m.n_experts)
    return 6 * d * cfg.d_ff


def fwd_flops_per_token(cfg: ModelConfig, ctx: float,
                        decode: bool = False) -> float:
    """Forward flops per (decoder) token at average attention context
    `ctx` (train/prefill causal: (S-1)/2; decode: full S)."""
    total = 2 * cfg.d_model * cfg.vocab                # unembed
    for i, kind in enumerate(cfg.pattern()):
        if kind == ATTN:
            total += _attn_flops_token(cfg, ctx)
        elif kind == ATTN_LOCAL:
            total += _attn_flops_token(cfg, min(ctx, cfg.window))
        elif kind == MLA:
            total += _mla_flops_token(cfg, ctx, decode)
        elif kind == RWKV:
            total += _rwkv_flops_token(cfg)
            continue                                   # ffn built-in
        elif kind == MAMBA:
            total += _mamba_flops_token(cfg)
        total += _ffn_flops_token(cfg, i)
    return total


def encoder_flops(cfg: ModelConfig, batch: int) -> float:
    """Whisper encoder / frontend-stub consumer flops (per step)."""
    if not cfg.enc_layers:
        if cfg.frontend == "vision_stub":
            fd = cfg.frontend_dim or cfg.d_model
            return 2 * fd * cfg.d_model * cfg.frontend_tokens * batch
        return 0.0
    Te, d = cfg.enc_tokens, cfg.d_model
    per_tok = (8 * d * d + 2 * Te * cfg.n_heads * cfg.head_dim * 2
               + 4 * d * cfg.d_ff)
    return per_tok * Te * batch


def step_flops(cfg: ModelConfig, shape: ShapeConfig,
               remat: bool = True) -> float:
    """Global flops of one step of the given mode."""
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        ctx = (S - 1) / 2
        fwd = fwd_flops_per_token(cfg, ctx) * B * S + encoder_flops(cfg, B)
        factor = 4.0 if remat else 3.0   # fwd + 2x bwd (+1 remat refwd)
        return fwd * factor
    if shape.mode == "prefill":
        ctx = (S - 1) / 2
        return fwd_flops_per_token(cfg, ctx) * B * S + encoder_flops(cfg, B)
    # decode: one token against full context
    ntok = B * 1
    fe = encoder_flops(cfg, 0)  # frontend consumed at prefill, not decode
    return fwd_flops_per_token(cfg, S, decode=True) * ntok + fe


# ---------------------------------------------------------------------------
# HBM traffic model (per chip)
# ---------------------------------------------------------------------------

def cache_bytes(cfg: ModelConfig, shape: ShapeConfig, act_bytes=2) -> float:
    """Global KV/state cache bytes at capacity seq_len."""
    B, S = shape.global_batch, shape.seq_len
    total = 0
    for kind in cfg.pattern():
        if kind == ATTN:
            total += B * S * cfg.n_kv_heads * cfg.head_dim * 2 * act_bytes
        elif kind == ATTN_LOCAL:
            C = min(S, cfg.window)
            total += B * C * cfg.n_kv_heads * cfg.head_dim * 2 * act_bytes
        elif kind == MLA:
            total += B * S * (cfg.kv_lora_rank + cfg.rope_head_dim) \
                * act_bytes
        elif kind == RWKV:
            total += B * cfg.n_heads * cfg.head_dim ** 2 * 4 \
                + 2 * B * cfg.d_model * act_bytes
        elif kind == MAMBA:
            di = cfg.ssm_expand * cfg.d_model
            total += B * di * cfg.ssm_state * 4 \
                + B * (cfg.ssm_conv - 1) * di * act_bytes
    if cfg.enc_layers:
        total += cfg.n_layers * B * cfg.enc_tokens * cfg.n_kv_heads \
            * cfg.head_dim * 2 * act_bytes
    return total


def step_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                   param_bytes=4, moment_bytes=4, act_bytes=2,
                   fsdp=False, model_axis=16, data_axis=16) -> float:
    """Per-chip HBM traffic of one step (weights + activations + cache).

    Weight traffic counts the *local shard* (tensor-parallel over
    `model`; FSDP additionally shards storage over `data`, but the
    all-gathered copy is still read from HBM once per use, so the read
    traffic stays P/model_axis)."""
    P = cfg.param_count()
    B, S = shape.global_batch, shape.seq_len
    p_read_local = P * param_bytes / model_axis
    if shape.mode == "train":
        # fwd read + bwd read + remat read + grad write + opt read/write
        p_store_local = P / (model_axis * (data_axis if fsdp else 1))
        weights = (p_read_local * 3
                   + p_store_local * (param_bytes * 2    # grad w + p w
                                      + moment_bytes * 4))  # m,v r+w
        tokens_local = B * S / chips * model_axis  # activations are
        # sharded over batch only; model axis replicates token activations
        acts = tokens_local * cfg.d_model * act_bytes * cfg.n_layers * 12
        return weights + acts * (1 / model_axis)  # heads/ffn sharded
    if shape.mode == "prefill":
        tokens_local = B * S / chips * model_axis
        acts = tokens_local * cfg.d_model * act_bytes * cfg.n_layers * 8
        cache = cache_bytes(cfg, shape, act_bytes) / chips
        return p_read_local + acts / model_axis + cache
    # decode: weights + full cache read per token
    cache = cache_bytes(cfg, shape, act_bytes) / chips
    return p_read_local + cache
