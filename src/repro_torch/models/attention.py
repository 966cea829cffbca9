"""Attention token mixers: GQA (full and sliding-window, self and cross)
and MLA, the port of src/repro/models/attention.py.

Paths per mixer, each as the reference routes it:
  * sequence (train, prefill, which may emit a cache), causal ATTN:
    under `AttnOpts.use_kernels` core/attention.py, the flash-attention
    dispatcher (the Hopper kernel for CUDA tensors, its plain version on
    the CPU); otherwise the model's own blockwise online softmax
    (`causal_attention` over `flash_block_attention`), chunked over the
    query axis so each chunk only multiplies against its own prefix;
  * local (ATTN_LOCAL, sliding window): the exact banded block attention
    `local_attention`, O(S·window), whatever `use_kernels`;
  * the whisper encoder (non-causal) and cross attention, and MLA: the
    blockwise online softmax, whatever `use_kernels` (the reference
    sends only causal ATTN to the kernel);
  * decode: one query token against a cache (a ring of `window` slots
    for local layers; MLA scores the compressed latents directly, its
    up-projections absorbed into the query and the output).
Weights keep the reference's einsum layouts: wq (d,H,D), wk/wv
(d,KVH,D), wo (H,D,d); MLA's wdq (d,rq), wuq (rq,H,D), wqr (rq,H,HR),
wdkv (d,rkv), wkr (d,HR), wuk/wuv (rkv,H,D).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ATTN, ATTN_LOCAL, MLA
from repro_torch.core.attention import attention as core_attention
from repro_torch.models.layers import (Params, apply_norm, apply_rope, dense,
                                       ones)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnOpts:
    dtype: torch.dtype = torch.bfloat16
    block_k: int = 512       # kv block for online softmax
    n_q_chunks: int = 8      # static causal query chunks
    use_kernels: bool = False  # route causal ATTN through the kernel
    moe_local: bool = False    # row-local MoE dispatch (see models/moe.py)


def attn_params(cfg, kind: str) -> Params:
    """Parameter templates of one mixer of `kind` (ATTN, ATTN_LOCAL or
    MLA), with the reference's key paths."""
    hd = cfg.head_dim
    if kind == MLA:
        rq = cfg.q_lora_rank or cfg.d_model
        rkv, hr, H = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.n_heads
        p = Params(wdq=((cfg.d_model, rq), dense()),
                   wuq=((rq, H, hd), dense()),
                   wqr=((rq, H, hr), dense()),
                   wdkv=((cfg.d_model, rkv), dense()),
                   wkr=((cfg.d_model, hr), dense()),
                   wuk=((rkv, H, hd), dense()),
                   wuv=((rkv, H, hd), dense()),
                   wo=((H, hd, cfg.d_model), dense()))
        p.q_norm = Params(scale=((rq,), ones))
        p.kv_norm = Params(scale=((rkv,), ones))
        return p
    if kind not in (ATTN, ATTN_LOCAL):
        raise ValueError(f"not an attention kind: {kind!r}")
    return Params(wq=((cfg.d_model, cfg.n_heads, hd), dense()),
                  wk=((cfg.d_model, cfg.n_kv_heads, hd), dense()),
                  wv=((cfg.d_model, cfg.n_kv_heads, hd), dense()),
                  wo=((cfg.n_heads, hd, cfg.d_model), dense()))


def init_cross_attn(cfg) -> Params:
    """Whisper decoder cross-attention (the same shapes as MHA)."""
    return attn_params(cfg, ATTN)


# ---------------------------------------------------------------------------
# Blockwise online-softmax attention core (plain PyTorch "flash")
# ---------------------------------------------------------------------------

def emit_ring(k, C):
    """Lay out per-position entries k (B,S,...) into a ring cache of
    capacity C such that position p sits in slot p % C. Requires C >= S
    (pad right) or S % C == 0 (keep last C — slots align)."""
    S = k.shape[1]
    if C >= S:
        return torch.nn.functional.pad(
            k, [0, 0] * (k.ndim - 2) + [0, C - S])
    if S % C:
        raise ValueError(f"ring cache needs S%C==0, got S={S} C={C}")
    return k[:, -C:]


def _pad_axis(x, axis, to_multiple):
    n = x.shape[axis]
    pad = (-n) % to_multiple
    if pad == 0:
        return x, n
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return torch.nn.functional.pad(x, widths), n


def flash_block_attention(q, k, v, q_pos, kv_pos0, *, causal: bool,
                          window: int, block_k: int, kv_valid_len=None):
    """q: (B,Sq,KVH,G,D) k/v: (B,T,KVH,Dk|Dv); returns (B,Sq,KVH,G,Dv).

    kv positions are kv_pos0 + arange(T); entries at index >=
    kv_valid_len (or None) are masked out. Online softmax over kv blocks
    keeps live memory at one (…, Sq, block_k) tile."""
    B, Sq, KVH, G, D = q.shape
    Dv = v.shape[-1]
    dev = q.device
    scale = D ** -0.5
    k, T0 = _pad_axis(k, 1, block_k)
    v, _ = _pad_axis(v, 1, block_k)
    T = k.shape[1]
    nk = T // block_k
    kpos = kv_pos0 + torch.arange(T, device=dev)
    kv_valid = torch.arange(T, device=dev) < (
        T0 if kv_valid_len is None else kv_valid_len)
    neg = torch.full((), NEG_INF, device=dev)

    qf = q.float() * scale
    m = torch.full((B, KVH, G, Sq), NEG_INF, device=dev)
    l = torch.zeros((B, KVH, G, Sq), device=dev)
    acc = torch.zeros((B, KVH, G, Sq, Dv), device=dev)
    for i in range(nk):
        blk = slice(i * block_k, (i + 1) * block_k)
        kp, kval = kpos[blk], kv_valid[blk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k[:, blk].float())
        mask = kval[None, :]
        if causal:
            mask = mask & (kp[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (kp[None, :] > q_pos[:, None] - window)
        s = torch.where(mask[None, None, None], s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, v[:, blk].float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B,Sq,KVH,G,Dv)


def causal_attention(q, k, v, pos0, *, n_q_chunks: int, block_k: int):
    """Causal full attention, q:(B,S,KVH,G,D) k,v:(B,S,KVH,D).

    Static loop over query chunks; chunk i only multiplies against its
    own kv prefix."""
    B, S, KVH, G, D = q.shape
    nq = max(1, min(n_q_chunks, S // max(1, min(block_k, S))))
    cs = -(-S // nq)  # ceil
    outs = []
    for i in range(nq):
        lo, hi = i * cs, min((i + 1) * cs, S)
        if lo >= S:
            break
        qpos = pos0 + torch.arange(lo, hi, device=q.device)
        outs.append(flash_block_attention(
            q[:, lo:hi], k[:, :hi], v[:, :hi], qpos, pos0,
            causal=True, window=0, block_k=min(block_k, hi)))
    return torch.cat(outs, dim=1)


def local_attention(q, k, v, pos0, *, window: int):
    """Exact banded sliding-window attention, O(S·window).

    The sequence is cut into blocks of `window`; each query block attends
    to [previous block ‖ own block] under the in-window mask. Positions
    count from 0 whatever `pos0`, as in the reference."""
    B, S, KVH, G, D = q.shape
    w = window
    dev = q.device
    q, S0 = _pad_axis(q, 1, w)
    k, _ = _pad_axis(k, 1, w)
    v, _ = _pad_axis(v, 1, w)
    S = q.shape[1]
    nb = S // w
    qb = q.reshape(B, nb, w, KVH, G, D)
    kb = k.reshape(B, nb, w, KVH, D)
    vb = v.reshape(B, nb, w, KVH, D)
    # previous block (block -1 is zeros, fully masked out by position)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kb], dim=2)  # (B,nb,2w,KVH,D)
    v2 = torch.cat([vprev, vb], dim=2)
    scale = D ** -0.5
    s = torch.einsum("bnqhgd,bnkhd->bnhgqk", qb.float() * scale, k2.float())
    qpos = torch.arange(S, device=dev).reshape(nb, w)         # (nb,w)
    kpos = ((torch.arange(2 * w, device=dev)[None] - w)
            + (torch.arange(nb, device=dev) * w)[:, None])    # (nb,2w)
    kp, qp = kpos[:, None, :], qpos[..., None]
    valid = ((kp <= qp) & (kp > qp - w) & (kp >= 0) & (kp < S0)
             & (qp < S0))
    s = torch.where(valid[None, :, None, None], s,
                    torch.full((), NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bnhgqk,bnkhd->bnqhgd", p, v2.float())
    o = o.reshape(B, S, KVH, G, D)[:, :S0]
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA mixer
# ---------------------------------------------------------------------------

def _qkv(cfg, p, x):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    return q, k, v


def gqa_seq(cfg, p, x, pos0, kind, opts: AttnOpts, cache_capacity=0,
            cross_kv=None, causal=True):
    """Full-sequence GQA. Returns (out, cache): for self-attention the KV
    cache {'k','v'} (B,C,KVH,D) laid out as a ring of capacity
    `cache_capacity` (of min(C, window) slots for a local layer), or None
    when it is 0 (train mode) and for cross attention, which attends
    (B,Te,KVH,D) encoder keys and values `cross_kv` without RoPE."""
    B, S, _ = x.shape
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KVH
    dev = x.device
    q, k, v = _qkv(cfg, p, x)
    if cross_kv is not None:
        ek, ev = cross_kv  # whisper cross attention
        qg = q.reshape(B, S, KVH, G, D)
        o = flash_block_attention(
            qg, ek, ev, torch.zeros((S,), dtype=torch.long, device=dev), 0,
            causal=False, window=0, block_k=min(opts.block_k, ek.shape[1]))
        o = o.reshape(B, S, H, D)
        return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype)), None
    positions = pos0 + torch.arange(S, device=dev)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    qg = q.reshape(B, S, KVH, G, D)
    if not causal:  # encoder self-attention: one non-causal pass
        o = flash_block_attention(qg, k, v, positions, pos0, causal=False,
                                  window=0, block_k=min(opts.block_k, S))
    elif kind == ATTN_LOCAL:
        o = local_attention(qg, k, v, pos0, window=cfg.window)
    elif opts.use_kernels:
        o = core_attention(qg, k, v, causal=True, use_kernel=True)
    else:
        o = causal_attention(qg, k, v, pos0, n_q_chunks=opts.n_q_chunks,
                             block_k=opts.block_k)
    o = o.reshape(B, S, H, D)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    cache = None
    if cache_capacity:
        C = cache_capacity
        if kind == ATTN_LOCAL:
            C = min(C, cfg.window)
        cache = {"k": emit_ring(k, C), "v": emit_ring(v, C)}
    return out, cache


def gqa_decode(cfg, p, x, cache, pos: int, kind, opts: AttnOpts,
               cross_kv=None):
    """One-token decode. x: (B,1,d); cache {'k','v'}: (B,C,KVH,D); pos:
    the position of this token. Writes its k and v into ring slot
    pos % C of the cache IN PLACE (the reference returns an updated copy)
    and attends over all C slots, in f32. Like the reference it assumes
    a full cache: slots not yet written hold zeros and are attended all
    the same (a reference quirk the port keeps, ROADMAP §3); a local
    layer's ring holds exactly its window, so every slot counts.

    With `cross_kv` (ek, ev) it attends those (B,Te,KVH,D) encoder keys
    and values instead, without RoPE, scores in the model's dtype and the
    softmax in f32, and leaves `cache` alone."""
    B = x.shape[0]
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KVH
    dt = x.dtype
    q, k, v = _qkv(cfg, p, x)
    if cross_kv is not None:
        ek, ev = cross_kv
        s = torch.einsum("bohk,bthk->bhot", q.reshape(B, 1, H, D) * D ** -0.5,
                         torch.repeat_interleave(ek, G, dim=2).to(dt))
        w = torch.softmax(s.float(), dim=-1).to(dt)
        o = torch.einsum("bhot,bthk->bohk", w,
                         torch.repeat_interleave(ev, G, dim=2))
        return torch.einsum("bohk,hkd->bod", o, p["wo"].to(dt))
    positions = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    slot = pos % ck.shape[1]
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    qg = q.reshape(B, 1, KVH, G, D).float() * D ** -0.5
    s = torch.einsum("bqhgd,bthd->bhgqt", qg, ck.float())  # (B,KVH,G,1,C)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqt,bthd->bqhgd", w, cv.float())
    o = o.reshape(B, 1, H, D).to(dt)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# MLA mixer (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

def _mla_q(cfg, p, x):
    dt = x.dtype
    cq = torch.einsum("bsd,dr->bsr", x, p["wdq"].to(dt))
    cq = apply_norm(p["q_norm"], cq)
    q_nope = torch.einsum("bsr,rhk->bshk", cq, p["wuq"].to(dt))
    q_rope = torch.einsum("bsr,rhk->bshk", cq, p["wqr"].to(dt))
    return q_nope, q_rope


def _mla_latents(cfg, p, x, positions):
    dt = x.dtype
    ckv = torch.einsum("bsd,dr->bsr", x, p["wdkv"].to(dt))
    ckv = apply_norm(p["kv_norm"], ckv)
    kr = torch.einsum("bsd,dk->bsk", x, p["wkr"].to(dt))
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return ckv, kr


def mla_seq(cfg, p, x, pos0, opts: AttnOpts, cache_capacity=0):
    """Full-sequence MLA: expand the latents to per-head K/V and run the
    causal blockwise path (q, k = [nope ‖ rope]). Returns (out, cache):
    the latent cache {'ckv' (B,C,rkv), 'kr' (B,C,HR)} or None."""
    B, S, _ = x.shape
    H, D, HR = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    dt = x.dtype
    positions = pos0 + torch.arange(S, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv, kr = _mla_latents(cfg, p, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["wuk"].to(dt))
    v = torch.einsum("bsr,rhk->bshk", ckv, p["wuv"].to(dt))
    q = torch.cat([q_nope, q_rope], dim=-1)                  # (B,S,H,D+HR)
    k = torch.cat([k_nope, kr[:, :, None].expand(B, S, H, HR)], dim=-1)
    qg = q.reshape(B, S, H, 1, D + HR)
    o = causal_attention(qg, k, v, pos0, n_q_chunks=opts.n_q_chunks,
                         block_k=opts.block_k)
    o = o.reshape(B, S, H, D)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dt))
    cache = None
    if cache_capacity:
        cache = {"ckv": emit_ring(ckv, cache_capacity),
                 "kr": emit_ring(kr, cache_capacity)}
    return out, cache


def mla_decode(cfg, p, x, cache, pos: int, opts: AttnOpts):
    """Absorbed-matmul MLA decode: W_uk folds into the query and W_uv
    into the output, so the scores run against the compressed latent
    cache, only (rkv + HR) a token. Writes this token's latents into ring
    slot pos % C IN PLACE; attends every slot in f32, as gqa_decode."""
    D, HR = cfg.head_dim, cfg.rope_head_dim
    dt = x.dtype
    positions = torch.full((1,), pos, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_t, kr_t = _mla_latents(cfg, p, x, positions)
    ckv, kr = cache["ckv"], cache["kr"]
    slot = pos % ckv.shape[1]
    ckv[:, slot] = ckv_t[:, 0]
    kr[:, slot] = kr_t[:, 0]
    # absorb W_uk into q: (B,1,H,D) x (r,H,D) -> (B,1,H,r)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"].to(dt))
    scale = (D + HR) ** -0.5
    s = (torch.einsum("bshr,btr->bhst", q_abs.float(), ckv.float())
         + torch.einsum("bshk,btk->bhst", q_rope.float(), kr.float())) * scale
    w = torch.softmax(s, dim=-1)                              # (B,H,1,C)
    o_lat = torch.einsum("bhst,btr->bshr", w, ckv.float())
    o = torch.einsum("bshr,rhk->bshk", o_lat.to(dt), p["wuv"].to(dt))
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dt))
