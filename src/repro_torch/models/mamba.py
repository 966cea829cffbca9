"""Mamba selective-SSM block (Jamba's recurrent layer, arXiv:2403.19887),
the port of src/repro/models/mamba.py.

x-dependent (B, C, dt); diagonal A (di, N):
    h_t = exp(dt_t ⊗ A) ⊙ h_{t-1} + (dt_t x_t) ⊗ B_t
    y_t = (h_t · C_t) + D ⊙ x_t
Sequence path: a loop over chunks of 32 steps carrying h in f32; within a
chunk the steps' affine maps h -> a·h + b are composed by a log-step
(Hillis–Steele) scan, exact in the algebra as the reference's
`lax.associative_scan` is, rounded in another order. Decode is the same
function at chunk 1: one step, the conv and ssm states carried in the
cache. Plain PyTorch: the reference has no kernel here either.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import (Params, const, dense, ones, sigmoid,
                                       silu, zeros)


def _a_log(generator, shape, dtype):
    """log(1 + n) for n = 1..N on every channel, f32 (the reference's
    A_log init)."""
    di, N = shape
    n = torch.arange(1, N + 1, dtype=torch.float32, device=generator.device)
    return torch.log(1.0 + n)[None, :].expand(di, N).contiguous()


def mamba_params(cfg) -> Params:
    """Parameter templates of one Mamba mixer, with the reference's key
    paths; the leaves it reads in f32 (conv_b, dt_bias, A_log, D) stay
    f32."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    return Params(in_proj=((d, 2 * di), dense()),
                  conv_w=((cfg.ssm_conv, di), dense(0.5)),
                  conv_b=((di,), zeros),
                  bc_proj=((di, 2 * N), dense()),
                  dt_proj=((di, 1), dense()),
                  dt_bias=((di,), const(-4.0)),
                  A_log=((di, N), _a_log),
                  D=((di,), ones),
                  out_proj=((di, d), dense()))


def _causal_conv(p, x, conv_state):
    """Depthwise causal conv as K shifted adds, summed in the reference's
    order. x: (B,T,di); conv_state: (B,K-1,di), the trailing inputs of the
    previous segment. Returns (out, the new trailing K-1 inputs)."""
    K = p["conv_w"].shape[0]
    dt = x.dtype
    xx = torch.cat([conv_state.to(dt), x], dim=1)
    n = xx.shape[1]
    out = 0
    for i in range(K):
        out = out + xx[:, K - 1 - i: n - i] * p["conv_w"][K - 1 - i].to(dt)
    return out + p["conv_b"].to(dt), xx[:, -(K - 1):]


def _compose(a, b):
    """Prefix compositions of the affine maps h -> a_t·h + b_t along dim
    1: returns (A_t, B_t) with h_t = A_t·h_0 + B_t (log-step scan)."""
    s = 1
    while s < a.shape[1]:
        b = torch.cat([b[:, :s], b[:, :-s] * a[:, s:] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1)
        s *= 2
    return a, b


def ssm_scan_chunked(u, dt_, B_, C_, A, state, chunk=32):
    """u, dt_: (B,T,di); B_, C_: (B,T,N); A: (di,N) (negative); state:
    (B,di,N). Returns (y (B,T,di), the final state)."""
    Bb, T, di = u.shape
    pad = (-T) % chunk
    if pad:  # zero steps are the identity map: a = 1, b = 0
        u, dt_, B_, C_ = (nn.functional.pad(t, (0, 0, 0, pad))
                          for t in (u, dt_, B_, C_))
    ys = []
    h0 = state
    for c in range(0, T + pad, chunk):
        ub, dtb, Bb_, Cb = (t[:, c:c + chunk] for t in (u, dt_, B_, C_))
        a = torch.exp(dtb[..., None] * A)                # (B,L,di,N)
        b = (dtb * ub)[..., None] * Bb_[:, :, None]      # (B,L,di,N)
        acc_a, acc_b = _compose(a, b)
        h = acc_a * h0[:, None] + acc_b                  # (B,L,di,N)
        ys.append(torch.einsum("bldn,bln->bld", h, Cb))
        h0 = h[:, -1]
    return torch.cat(ys, dim=1)[:, :T], h0


def mamba_seq(cfg, p, x, state, chunk=32):
    """x: (B,T,d); state: {'conv': (B,K-1,di) in x's dtype, 'ssm':
    (B,di,N) f32}. Returns (out (B,T,d), the new state)."""
    dt = x.dtype
    di = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    xz = torch.einsum("btd,de->bte", x, p["in_proj"].to(dt))
    u, z = xz[..., :di], xz[..., di:]
    u, conv_state = _causal_conv(p, u, state["conv"])
    # silu(u) = u · sigmoid(u): the reference's compiled bf16 graph rounds
    # that product for the two projections but hands the scan and the
    # D·u residual its f32 value, unrounded
    uf = u.float() * sigmoid(u).float()
    u = uf.to(dt)
    bc = torch.einsum("bte,en->btn", u, p["bc_proj"].to(dt))
    B_, C_ = bc[..., :N].float(), bc[..., N:].float()
    dt_ = nn.functional.softplus(
        torch.einsum("bte,eo->bto", u, p["dt_proj"].to(dt)).float()
        + p["dt_bias"])                     # (B,T,1) + (di,) -> (B,T,di)
    A = -torch.exp(p["A_log"])
    y, ssm_state = ssm_scan_chunked(uf, dt_, B_, C_, A, state["ssm"].float(),
                                    chunk=chunk)
    y = y + p["D"] * uf
    y = y.to(dt) * silu(z)
    out = torch.einsum("bte,ed->btd", y, p["out_proj"].to(dt))
    return out, {"conv": conv_state, "ssm": ssm_state}


def mamba_decode(cfg, p, x, state):
    """One-step decode; x: (B,1,d)."""
    return mamba_seq(cfg, p, x, state, chunk=1)
