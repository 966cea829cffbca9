"""Attention token mixer: the grouped-query (GQA) paths of
src/repro/models/attention.py for the `ATTN` kind — full-sequence causal
attention (train, prefill, which may emit a KV cache) and one-token
decode against that cache.

Two execution paths for the full sequence, chosen by
`AttnOpts.use_kernels` as in the reference:
  * kernels on: core/attention.py, the flash-attention dispatcher (the
    Hopper kernel for CUDA tensors, its plain version on the CPU);
  * kernels off: the model's own blockwise online softmax
    (`causal_attention` over `flash_block_attention`), chunked over the
    query axis so each chunk only multiplies against its own prefix.
Weights keep the reference's einsum layouts: wq (d,H,D), wk/wv
(d,KVH,D), wo (H,D,d).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ATTN
from repro_torch.core.attention import attention as core_attention
from repro_torch.models.layers import Params, apply_rope, dense

NEG_INF = -1e30


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the LM zoo (ROADMAP "
        f"queue 1, item 15)")


@dataclasses.dataclass(frozen=True)
class AttnOpts:
    dtype: torch.dtype = torch.bfloat16
    block_k: int = 512       # kv block for online softmax
    n_q_chunks: int = 8      # static causal query chunks
    use_kernels: bool = False  # route seq attention through the kernel
    moe_local: bool = False    # row-local MoE dispatch (not ported)


def attn_params(cfg, kind: str) -> Params:
    if kind != ATTN:
        raise _not_ported(f"attention kind {kind!r}")
    hd = cfg.head_dim
    return Params(wq=((cfg.d_model, cfg.n_heads, hd), dense()),
                  wk=((cfg.d_model, cfg.n_kv_heads, hd), dense()),
                  wv=((cfg.d_model, cfg.n_kv_heads, hd), dense()),
                  wo=((cfg.n_heads, hd, cfg.d_model), dense()))


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
            causal=True):
    """Full-sequence causal GQA with RoPE. Returns (out, cache): the KV
    cache {'k','v'} (B,C,KVH,D) laid out as a ring of capacity
    `cache_capacity`, or None when it is 0 (train mode)."""
    if kind != ATTN or not causal:
        raise _not_ported(f"GQA kind {kind!r} (causal={causal})")
    B, S, _ = x.shape
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KVH
    q, k, v = _qkv(cfg, p, x)
    positions = pos0 + torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    qg = q.reshape(B, S, KVH, G, D)
    if opts.use_kernels:
        o = core_attention(qg, k, v, causal=True, use_kernel=True)
    else:
        o = causal_attention(qg, k, v, pos0, n_q_chunks=opts.n_q_chunks,
                             block_k=opts.block_k)
    o = o.reshape(B, S, H, D)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    cache = None
    if cache_capacity:
        cache = {"k": emit_ring(k, cache_capacity),
                 "v": emit_ring(v, cache_capacity)}
    return out, cache


def gqa_decode(cfg, p, x, cache, pos: int, kind, opts: AttnOpts):
    """One-token decode. x: (B,1,d); cache {'k','v'}: (B,C,KVH,D); pos:
    the position of this token. Writes its k and v into ring slot
    pos % C of the cache IN PLACE (the reference returns an updated copy)
    and attends over all C slots, in f32. Like the reference it assumes
    a full cache: slots not yet written hold zeros and are attended all
    the same (a reference quirk the port keeps, ROADMAP §3)."""
    if kind != ATTN:
        raise _not_ported(f"GQA decode of kind {kind!r}")
    B = x.shape[0]
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KVH
    dt = x.dtype
    q, k, v = _qkv(cfg, p, x)
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
