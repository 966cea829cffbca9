"""Mixture-of-experts FFN: top-k router + sort-based grouped matmul (the
port of src/repro/models/moe.py).

Flatten the tokens, sort the (token, expert) assignments by expert, pack
them into a capacity-padded (E, C, d) buffer, run the grouped matmul (the
Hopper `gmm_ecd` kernel for CUDA tensors under `use_kernels`, its plain
version on the CPU, the model's own einsum otherwise), then combine each
token's K expert outputs with its router weights.

Where the reference leans on scatters, the port gathers, so no index is
written twice and no float atomic decides an order:
  * the (E, C, d) buffer: slot (e, c) reads the c-th assignment of
    expert e in sorted order when expert e has more than c, else zero
    (the reference scatters every assignment and sends the dropped ones
    to one spare slot);
  * the combine: each token sums its K weighted expert outputs in
    ascending expert order, the order in which the reference's
    scatter-add meets them, in f32 as its compiled graph does.
The router's top-k is a stable descending sort, so ties go to the lower
expert index as in `jax.lax.top_k` (`torch.topk` promises no order).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import Params, apply_mlp, dense, silu
from repro_torch.tracing import count as trace_count, span, spanned


def init_moe(cfg) -> Params:
    """Parameter templates of one MoE FFN, with the reference's key paths:
    router (d,E), wi/wg (E,d,f), wo (E,f,d), shared/{wi,wg,wo}."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff, m.n_experts
    p = Params(router=((d, E), dense()), wi=((E, d, f), dense()),
               wg=((E, d, f), dense()), wo=((E, f, d), dense()))
    if m.n_shared:
        fs = f * m.n_shared
        p.shared = Params(wi=((d, fs), dense()), wg=((d, fs), dense()),
                          wo=((fs, d), dense()))
    return p


@spanned("repro_torch.moe.experts")
def _gmm(x, w, use_kernels, rows=None):
    """Grouped matmul: (E,C,d) @ (E,d,f) -> (E,C,f). rows: each expert's
    count of rows of x that hold input (the rest are zero); the kernel
    never reads the rows past it and skips the row tiles that hold none,
    the einsum multiplies them (zeros either way)."""
    if use_kernels:
        from repro_torch.kernels.gmm import ops as gmm_ops
        return gmm_ops.gmm(x, w, rows)
    return torch.einsum("ecd,edf->ecf", x, w.to(x.dtype))


@spanned("repro_torch.moe")
def apply_moe(cfg, p, x, use_kernels=False, local_dispatch=False):
    """x: (B,S,d) -> (out (B,S,d), aux_loss f32 scalar).

    local_dispatch=True dispatches each batch row on its own (the
    reference vmaps the dispatch over rows, so the sort and scatter stay
    local to a data shard): each row's capacity comes from its S tokens,
    its experts run on the model's own einsum (`use_kernels` is not
    passed on, as in the reference), and aux is the mean over the rows.
    The global path sorts all B·S tokens together."""
    B, S, d = x.shape
    if local_dispatch:
        outs, auxs = zip(*(_dispatch_tokens(cfg, p, x[b], False)
                           for b in range(B)))
        out, aux = torch.stack(outs), torch.stack(auxs).mean()
    else:
        out, aux = _dispatch_tokens(cfg, p, x.reshape(B * S, d),
                                    use_kernels)
        out = out.reshape(B, S, d)
    if cfg.moe.n_shared:
        with span("repro_torch.moe.shared"):
            shared = apply_mlp(p["shared"], x)
        out = out + shared
    return out, aux


@spanned("repro_torch.moe.route")
def _route(cfg, p, xt):
    """Router gates (T,E) f32 and the top-k (weights renormalized, expert
    indices), ties to the lower index."""
    m = cfg.moe
    # the logits are read in f32 only: the reference's compiled graph
    # folds that convert into the product, which leaves the f32
    # accumulator unrounded, so the port multiplies the (exact) f32
    # values of the model-dtype operands
    logits = torch.einsum("td,de->te", xt.float(),
                          p["router"].to(xt.dtype).float())
    gates = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :m.top_k], topi[:, :m.top_k]
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    return gates, topv, topi


def _dispatch_tokens(cfg, p, xt, use_kernels):
    """Routed-expert compute for a flat (T, d) token block."""
    m = cfg.moe
    T, d = xt.shape
    E, K = m.n_experts, m.top_k
    dt, dev = xt.dtype, xt.device
    gates, topv, topi = _route(cfg, p, xt)

    # load-balance aux loss (Switch-style)
    density = nn.functional.one_hot(topi[:, 0], E).float().mean(0)
    aux = (density * gates.mean(0)).sum() * E * m.aux_loss_coef

    # ---- sort-by-expert dispatch with capacity ----
    C = int(max(8, round(T * K / E * m.capacity_factor)))
    with span("repro_torch.moe.dispatch"):
        fe = topi.reshape(-1)                                  # (T*K,)
        order = torch.argsort(fe, stable=True)
        se = fe[order]
        tok_of = order // K
        first = torch.searchsorted(se, se, side="left")
        rank = torch.arange(T * K, device=dev) - first         # rank in group
        keep = rank < C
        dest = se * C + rank                                   # slot if kept

        # gather, slot (e, c) <- the c-th assignment of expert e, if any
        experts = torch.arange(E, device=dev)
        start = torch.searchsorted(se, experts, side="left")
        count = torch.searchsorted(se, experts, side="right") - start
        # each expert's load beside its capacity: min(load, C) rows of the
        # E·C the experts multiply are routed, max(load - C, 0) dropped
        trace_count("repro_torch.moe.expert_load",
                    {"load": count, "capacity": C, "assigned": T * K})
        c = torch.arange(C, device=dev)
        src = torch.clamp_max(start[:, None] + c, T * K - 1)  # (E, C)
        filled = c < count[:, None]
        eb = torch.where(filled[..., None], xt[tok_of[src]],
                         torch.zeros((), dtype=dt, device=dev))  # (E,C,d)

    # rows of eb past count[e] are zero: the kernel writes their outputs
    # as zeros without reading them
    h = _gmm(eb, p["wi"], use_kernels, rows=count)
    g = _gmm(eb, p["wg"], use_kernels, rows=count)
    o = _gmm(silu(g) * h, p["wo"], use_kernels, rows=count)  # (E,C,d)

    with span("repro_torch.moe.combine"):
        o_flat = o.reshape(E * C, d)
        gathered = torch.where(keep[:, None],
                               o_flat[torch.clamp_max(dest, E * C - 1)],
                               torch.zeros((), dtype=dt, device=dev))
        w_sorted = topv.reshape(-1)[order][:, None].to(dt)
        contrib = gathered * w_sorted                          # sorted order

        # combine: each token's K entries in ascending expert (= sorted)
        # order, summed in f32 and rounded once, as the reference's
        # compiled scatter-add does
        inv = torch.empty_like(order)
        inv[order] = torch.arange(T * K, device=dev)
        at = torch.sort(inv.reshape(T, K), dim=1).values       # (T, K)
        out = torch.zeros((T, d), dtype=torch.float32, device=dev)
        for j in range(K):
            out = out + contrib[at[:, j]]
        out = out.to(dt)
    return out, aux


def apply_moe_dense_oracle(cfg, p, x):
    """O(T*E) dense-dispatch oracle — math-identical to apply_moe when no
    token is dropped. Used by tests only."""
    m = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    dt = x.dtype
    _, topv, topi = _route(cfg, p, xt)
    comb = torch.zeros((xt.shape[0], m.n_experts), dtype=torch.float32,
                       device=x.device)
    comb.scatter_add_(1, topi, topv)
    h = torch.einsum("td,edf->tef", xt, p["wi"].to(dt))
    g = torch.einsum("td,edf->tef", xt, p["wg"].to(dt))
    o = torch.einsum("tef,efd->ted", silu(g) * h,
                     p["wo"].to(dt))
    out = torch.einsum("ted,te->td", o.float(), comb).to(dt)
    if m.n_shared:
        out = out + apply_mlp(p["shared"], xt)
    return out.reshape(B, S, d)
