"""Plain PyTorch reference of the port's decoder stack, in float32.

It follows the equations the port states for its models, written out
again from the published descriptions and the configuration file: no
module of the program is imported, and nothing the program made is used.

  * RMSNorm with eps 1e-6 and a learned scale; pre-norm residual blocks;
  * grouped-query attention, causal, RoPE (half-split rotation) on q and
    k from position 0, scale D^-1/2, query head h reading key head
    h // (H / KVH);
  * SwiGLU feed-forward, silu(x Wg) * (x Wi) Wo;
  * mixture of experts: softmax router in float32, the top k by a stable
    descending sort, their weights renormalised to sum 1; each expert
    keeps the first C = max(8, round(T K / E * capacity_factor)) of the
    tokens routed to it in token order and drops the rest; the kept
    outputs are summed with their router weights; shared experts are one
    SwiGLU of width n_shared * d_ff over every token.

Every matrix product goes through `mm`, so the control can run the same
reference with its products in TF32 (`precision="tf32"`): on the card by
cuBLAS's TF32 path, on the CPU by rounding both operands to TF32's 10-bit
mantissa first, which is what the tensor cores read.
"""
from __future__ import annotations

import contextlib
import math

import torch


def set_plain_precision():
    """TF32 off for float32 products and convolutions: the reference and
    the program it judges both compute in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tf32(x):
    """x with its float32 mantissa rounded to TF32's 10 bits (to nearest,
    ties away from zero, as the tensor cores' conversion); the gradient
    passes through unchanged."""
    d = x.detach()
    i = d.contiguous().view(torch.int32)
    return x + (((i + 0x1000) & -0x2000).view(torch.float32) - d)


@contextlib.contextmanager
def _tf32_on():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def mm(eq, a, b, precision="float32"):
    """torch.einsum(eq, a, b) in float32, or with TF32 products."""
    if precision == "float32":
        return torch.einsum(eq, a, b)
    if precision != "tf32":
        raise ValueError(f"unknown precision {precision!r}")
    if a.is_cuda:
        with _tf32_on():
            return torch.einsum(eq, a, b)
    return torch.einsum(eq, to_tf32(a), to_tf32(b))


def rms_norm(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x: (B, S, H, D) at positions 0 .. S-1."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    ang = torch.arange(x.shape[1], dtype=torch.float32,
                       device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, precision="float32", q_block=1024):
    """q: (B, S, H, D), k, v: (B, S, KVH, D) -> (B, S, H, D); softmax in
    float32 over the keys at or before each query, in blocks of queries
    so that a long prompt's scores fit."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kh = k.repeat_interleave(G, dim=2)      # query head h reads h // G
    vh = v.repeat_interleave(G, dim=2)
    out = torch.empty_like(q)
    for lo in range(0, S, q_block):
        hi = min(lo + q_block, S)
        s = mm("bqhd,bkhd->bhqk", q[:, lo:hi] * D ** -0.5, kh[:, :hi],
               precision)
        mask = (torch.arange(hi, device=q.device)[None, :]
                <= torch.arange(lo, hi, device=q.device)[:, None])
        s = s.masked_fill(~mask, float("-inf"))
        out[:, lo:hi] = mm("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                           vh[:, :hi], precision)
    return out


def attention_block(p, x, cfg, precision="float32"):
    """The token mixer over normed input x: (B, S, d)."""
    q = rope(mm("bsd,dhk->bshk", x, p["wq"], precision), cfg["rope_theta"])
    k = rope(mm("bsd,dhk->bshk", x, p["wk"], precision), cfg["rope_theta"])
    v = mm("bsd,dhk->bshk", x, p["wv"], precision)
    o = causal_attention(q, k, v, precision)
    return mm("bshk,hkd->bsd", o, p["wo"], precision)


def swiglu(x, wi, wg, wo, precision="float32"):
    h = mm("...d,df->...f", x, wi, precision)
    g = mm("...d,df->...f", x, wg, precision)
    return mm("...f,fd->...d", torch.nn.functional.silu(g) * h, wo,
              precision)


def capacity(T, m):
    """The tokens each expert keeps out of T, as the configuration states."""
    K, E = m["top_k"], m["n_experts"]
    return int(max(8, round(T * K / E * m["capacity_factor"])))


def moe(p, x, m, precision="float32"):
    """x: (T, d) -> (T, d): routed experts with capacity, then the shared
    experts."""
    T = x.shape[0]
    gates = torch.softmax(mm("td,de->te", x, p["router"], precision), -1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :m["top_k"]], topi[:, :m["top_k"]]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    C = capacity(T, m)
    out = torch.zeros_like(x)
    for e in range(m["n_experts"]):
        tok, slot = (topi == e).nonzero(as_tuple=True)  # token order
        tok, slot = tok[:C], slot[:C]
        if tok.numel():
            y = swiglu(x[tok], p["wi"][e], p["wg"][e], p["wo"][e], precision)
            out.index_add_(0, tok, y * topv[tok, slot, None])
    if m["n_shared"]:
        s = p["shared"]
        out = out + swiglu(x, s["wi"], s["wg"], s["wo"], precision)
    return out


def layer_names(cfg):
    """Each layer's key prefix in the program's flat params: the leading
    dense layers under prefix/<i>, the rest under stack/<r>/t0 (a period
    of one layer, the only pattern these configurations use)."""
    lead = cfg["moe"]["first_dense"] if cfg.get("moe") else 0
    return [f"prefix/{i}" if i < lead else f"stack/{i - lead}/t0"
            for i in range(cfg["n_layers"])]


def sub(params, prefix):
    """The flat params under `prefix/` as a nested dict of their keys."""
    out = {}
    head = prefix + "/"
    for key, val in params.items():
        if key.startswith(head):
            node = out
            *path, leaf = key[len(head):].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = val
    return out


def block(p, x, cfg, is_moe, precision="float32"):
    """One pre-norm layer over x: (B, S, d)."""
    x = x + attention_block(p["mixer"], rms_norm(x, p["norm1"]["scale"]),
                            cfg, precision)
    h = rms_norm(x, p["norm2"]["scale"])
    if is_moe:
        B, S, d = h.shape
        o = moe(p["ffn"], h.reshape(B * S, d), cfg["moe"],
                precision).reshape(B, S, d)
    else:
        f = p["ffn"]
        o = swiglu(h, f["wi"], f["wg"], f["wo"], precision)
    return x + o


def run_blocks(params, x, cfg, prefix="", precision="float32"):
    """The whole stack over embedded x: (B, S, d), layer by layer."""
    lead = cfg["moe"]["first_dense"] if cfg.get("moe") else 0
    for i, name in enumerate(layer_names(cfg)):
        is_moe = bool(cfg.get("moe")) and i >= lead
        x = block(sub(params, prefix + name), x, cfg, is_moe, precision)
    return x


@torch.no_grad()
def last_logits(params, tokens, cfg, precision="float32"):
    """A prompt's next-token logits: tokens (1, S) int -> (V,) float32."""
    x = params["embed/tok"][tokens]
    x = run_blocks(params, x, cfg, "", precision)
    h = rms_norm(x[:, -1], params["final_norm/scale"])
    return mm("bd,dv->bv", h, params["embed/unembed"], precision)[0]


def head_dim(cfg):
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def with_head_dim(cfg):
    """The configuration with `head_dim` filled in (d_model / n_heads
    where the file gives none)."""
    return dict(cfg, head_dim=head_dim(cfg))


def rel_gap(a, b):
    """|a - b| / |b|, 0 where both are 0."""
    a, b = float(a), float(b)
    if a == b:
        return 0.0
    return abs(a - b) / abs(b) if b else math.inf
