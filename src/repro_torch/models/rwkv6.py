"""RWKV-6 "Finch" block (arXiv:2404.05892): data-dependent decay WKV (the
port of src/repro/models/rwkv6.py).

Time-mix: token-shift with data-dependent lerp (low-rank), per-head
matrix-valued state S ∈ R^{N×N}:
    y_t = r_t · (S_{t-1} + u ⊙ k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ          (w_t data-dependent)
Channel-mix: token-shift + squared-relu 2-matrix FFN.

Two WKV paths, chosen by `use_kernels`:
  * off: the reference's own chunked WKV (`wkv_chunked`): within a chunk
    the decay products are pairwise exp(cum_t − cum_j) (differences of
    logs <= 0, so no overflow), the inter-chunk state carried by a loop;
  * on: kernels/wkv6 (the Hopper `wkv6_btHN` kernel for CUDA tensors, its
    per-step plain version on the CPU), which the reference's model does
    not call but which computes the same function in the same blocking.
Leaves the reference reads in f32 whatever the model's dtype (the lerp
and decay constants, `u`, the head-norm scale, and the decay LoRA `wa`,
`wb`) are stored in f32.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import (Params, const, dense, ones, sigmoid,
                                       zeros)

LORA_RANK = 64      # the decay LoRA's rank
MIX_RANK = 32       # the token-shift lerp LoRA's rank (per mix)


def init_rwkv(cfg) -> Params:
    """Parameter templates of one RWKV-6 mixer (time mix and channel mix),
    with the reference's key paths."""
    d, H, N = cfg.d_model, cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    return Params(
        # data-dependent token-shift lerp (5 mixes: r,k,v,w,g)
        mu=((5, d), const(0.5)),
        mix_a=((d, 5 * MIX_RANK), dense()),
        mix_b=((5, MIX_RANK, d), dense(0.1)),
        wr=((d, d), dense()), wk=((d, d), dense()), wv=((d, d), dense()),
        wg=((d, d), dense()), wo=((d, d), dense()),
        # decay: w = exp(-exp(w0 + lora(x)))
        w0=((d,), const(-6.0)),
        wa=((d, LORA_RANK), dense(dtype=f32)),
        wb=((LORA_RANK, d), dense(0.1, dtype=f32)),
        u=((H, N), zeros),              # first-token bonus
        ln_scale=((H, N), ones),        # per-head groupnorm
        # channel mix
        cm_mu=((2, d), const(0.5)),
        cm_k=((d, cfg.d_ff), dense()), cm_v=((cfg.d_ff, d), dense()),
        cm_r=((d, d), dense()))


def _token_shift(x, last):
    """x: (B,T,d); last: (B,d) previous token (state). Returns shifted x
    and the new last-token state."""
    prev = torch.cat([last[:, None], x[:, :-1]], dim=1)
    return prev, x[:, -1]


def _ddlerp(p, x, prev):
    """Data-dependent lerp producing the 5 mixed inputs (r,k,v,w,g)."""
    dt = x.dtype
    base = x + (prev - x) * p["mu"][0].to(dt)      # use mu_r as the probe
    lo = torch.einsum("btd,dr->btr", torch.tanh(base), p["mix_a"].to(dt))
    lo = lo.reshape(*lo.shape[:-1], 5, MIX_RANK)
    delta = torch.einsum("btfr,frd->btfd", lo, p["mix_b"].to(dt))
    mix = p["mu"].to(dt) + delta                   # (B,T,5,d)
    xs = x[:, :, None] + (prev - x)[:, :, None] * mix
    return xs.unbind(2)


def _rkvwg(cfg, p, x, prev):
    dt = x.dtype
    xr, xk, xv, xw, xg = _ddlerp(p, x, prev)
    B, T, d = x.shape
    H, N = cfg.n_heads, cfg.head_dim

    def proj(xi, w):
        return torch.einsum("btd,de->bte", xi, p[w].to(dt))

    r = proj(xr, "wr").reshape(B, T, H, N)
    k = proj(xk, "wk").reshape(B, T, H, N)
    v = proj(xv, "wv").reshape(B, T, H, N)
    g = proj(xg, "wg")
    g = g * sigmoid(g)                            # jax.nn.silu
    logw = -torch.exp(
        p["w0"].float()
        + torch.einsum("btd,dr->btr", torch.tanh(xw).float(),
                       p["wa"].float())
        @ p["wb"].float())                         # (B,T,d) <= 0
    return r, k, v, g, logw.reshape(B, T, H, N)


def wkv_chunked(r, k, v, logw, u, state, chunk=64):
    """Chunked WKV. r,k,v,logw: (B,T,H,N) f32; u: (H,N); state: (B,H,N,N).
    Returns (y (B,T,H,N), final state)."""
    B, T, H, N = r.shape
    pad = (-T) % chunk
    if pad:
        r, k, v, logw = (nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    nc = (T + pad) // chunk
    tri = torch.arange(chunk, device=r.device)
    tri = (tri[:, None] > tri[None])[None, :, :, None, None]
    S, ys = state, []
    for ic in range(nc):
        rb, kb, vb, lw = (a[:, ic * chunk:(ic + 1) * chunk]
                          for a in (r, k, v, logw))   # (B,L,H,N)
        c = torch.cumsum(lw, dim=1)                # inclusive cumsum
        cprev = c - lw                             # c_{t-1}
        # intra-chunk: score[t,j] = sum_i r_t k_j exp(c_{t-1}-c_j), j<t
        dmat = cprev[:, :, None] - c[:, None]      # (B,t,j,H,N)
        dmat = torch.where(tri, dmat, -torch.inf)
        score = torch.einsum("bthn,bjhn,btjhn->btjh", rb, kb,
                             torch.exp(dmat))
        # diagonal u-bonus term
        sdiag = torch.einsum("bthn,hn,bthn->bth", rb, u, kb)
        y = torch.einsum("btjh,bjhn->bthn", score, vb) \
            + sdiag[..., None] * vb
        # inter-chunk: y_t += (r_t * exp(c_{t-1})) @ S
        y = y + torch.einsum("bthn,bhnm->bthm", rb * torch.exp(cprev), S)
        # state update: S' = exp(c_L) S + sum_j exp(c_L - c_j) k_j v_j^T
        cl = c[:, -1]                              # (B,H,N)
        S = torch.exp(cl)[..., None] * S + torch.einsum(
            "bjhn,bjhm->bhnm", kb * torch.exp(cl[:, None] - c), vb)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :T], S


def _headnorm(p, y, eps=1e-5):
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    return (y - mu) * torch.rsqrt(var + eps) * p["ln_scale"]


def rwkv_time_mix_seq(cfg, p, x, state, chunk=64, use_kernels=False):
    """x: (B,T,d); state: {'S': (B,H,N,N), 'shift': (B,d)}. With
    `use_kernels` the WKV runs in kernels/wkv6, which writes the new S
    over an f32 state['S'] (the cache's buffer)."""
    B, T, d = x.shape
    prev, new_shift = _token_shift(x, state["shift"])
    r, k, v, g, logw = _rkvwg(cfg, p, x, prev)
    if use_kernels:  # the kernel reads bf16 or f32 r, k, v, u as they are
        from repro_torch.kernels.wkv6 import ops as wkv6_ops
        y, S = wkv6_ops.wkv6(r, k, v, logw, p["u"], chunk, state["S"])
    else:
        r, k, v, u, S = (a.float() for a in (r, k, v, p["u"], state["S"]))
        y, S = wkv_chunked(r, k, v, logw, u, S, chunk=chunk)
    y = _headnorm(p, y).reshape(B, T, d).to(x.dtype) * \
        g.reshape(B, T, d)
    out = torch.einsum("btd,de->bte", y, p["wo"].to(x.dtype))
    return out, {"S": S, "shift": new_shift}


def rwkv_channel_mix(cfg, p, x, shift_state):
    dt = x.dtype
    prev, new_shift = _token_shift(x, shift_state)
    xk = x + (prev - x) * p["cm_mu"][0].to(dt)
    xr = x + (prev - x) * p["cm_mu"][1].to(dt)
    kk = torch.square(torch.relu(
        torch.einsum("btd,df->btf", xk, p["cm_k"].to(dt))))
    vv = torch.einsum("btf,fd->btd", kk, p["cm_v"].to(dt))
    rr = sigmoid(torch.einsum("btd,de->bte", xr, p["cm_r"].to(dt)))
    return rr * vv, new_shift
