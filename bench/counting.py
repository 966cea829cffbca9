"""The yardstick's arithmetic: the card's published peaks, the model FLOPs
behind the MFU metrics and the operations and bytes behind each kernel's
roofline bound.

Copied from the port's own arithmetic (`launch/analytic.py`'s
`fwd_flops_per_token`, `chip_smoke.py`'s bound: bytes at the HBM rate,
operations at the dtype's peak) so that a change to the program cannot
move the yardstick. Everything here reads plain numbers and shapes: no
tensor is touched.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit. TF32 stays off in the program, so float32 matmuls
# run on the FMA units at the float32 rate.
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
              "float16": 989e12}
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the card could take for this work: the larger of
    its operations at the dtype's peak and its bytes at the HBM rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


# --------------------------------------------------------------- model FLOPs

def _attn_flops_token(cfg: dict, ctx: float) -> float:
    """Forward FLOPs a token of one GQA layer at average context `ctx`."""
    H, KVH, hd, d = (cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                     cfg["d_model"])
    proj = 2 * d * H * hd * 2 + 2 * d * KVH * hd * 2   # q, o + k, v
    attn = 2 * ctx * H * hd * 2                         # qk^T + pv
    return proj + attn


def is_moe_layer(cfg: dict, i: int) -> bool:
    m = cfg.get("moe")
    if not m or i < m["first_dense"]:
        return False
    return (i - m["first_dense"]) % m["every"] == 0


def _ffn_flops_token(cfg: dict, i: int) -> float:
    d = cfg["d_model"]
    if is_moe_layer(cfg, i):
        m = cfg["moe"]
        return (6 * d * m["d_ff"] * (m["top_k"] + m["n_shared"])
                + 2 * d * m["n_experts"])
    return 6 * d * cfg["d_ff"]


def blocks_flops_per_token(cfg: dict, ctx: float) -> float:
    """Forward FLOPs a token of the block stack (attention layers only)
    at average attention context `ctx`: causal over S tokens, (S - 1) / 2."""
    return sum(_attn_flops_token(cfg, ctx) + _ffn_flops_token(cfg, i)
               for i in range(cfg["n_layers"]))


def prefill_flops(cfg: dict, seq_len: int) -> float:
    """Model FLOPs of one prefill of `seq_len` tokens: the block stack over
    every token and the unembedding of the last one, which is all a
    prefill unembeds."""
    return (seq_len * blocks_flops_per_token(cfg, (seq_len - 1) / 2)
            + 2 * cfg["d_model"] * cfg["vocab"])


def trunk_forward_flops(cfg: dict, samples: int, positions: int,
                        n_actions: int) -> float:
    """Forward FLOPs of the policy trunk over `samples` observations of
    `positions` feature positions each: the feature lift, the blocks and
    the policy and value heads at the last position."""
    d = cfg["d_model"]
    per_sample = (positions * (2 * d + blocks_flops_per_token(
        cfg, (positions - 1) / 2)) + 2 * d * (n_actions + 1))
    return samples * per_sample


# ----------------------------------------------------------- kernel bounds

def attention_fwd_work(B: int, H: int, KVH: int, S: int, D: int,
                       causal: bool = True, lse: bool = False,
                       dtype: str = "float32"):
    """(flops, bytes) of one attention forward over (B, H, S, D) queries and
    (B, KVH, S, D) keys and values: q, k, v read once, o written once (and
    each row's log-sum-exp with `lse`); QK^T and PV over the pairs the
    mask keeps."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    e = DTYPE_BYTES[dtype]
    nbytes = e * (2 * B * S * H * D + 2 * B * S * KVH * D)
    if lse:
        nbytes += 4 * B * H * S
    return 4 * D * pairs, nbytes


def attention_bwd_work(B: int, H: int, KVH: int, S: int, D: int,
                       causal: bool = True, dtype: str = "float32"):
    """(flops, bytes) of one attention backward: q, k, v, o, do and the
    log-sum-exp read once, dq, dk, dv written once; QK^T recomputed, then
    dP = dO V^T, dV = P^T dO, dQ = dS K and dK = dS^T Q."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    e = DTYPE_BYTES[dtype]
    reads = e * (3 * B * S * H * D + 2 * B * S * KVH * D) + 4 * B * H * S
    writes = e * (B * S * H * D + 2 * B * S * KVH * D)
    return 10 * D * pairs, reads + writes


def gmm_work(rows_per_expert, d: int, f: int, dtype: str = "float32"):
    """(flops, bytes) of one grouped matmul (E, C, d) @ (E, d, f) over the
    rows routed to each expert, not the capacity-padded C: the routed rows
    read, the weights of each expert that has a row read, the routed rows
    of the output written."""
    e = DTYPE_BYTES[dtype]
    rows = sum(rows_per_expert)
    used = sum(1 for r in rows_per_expert if r)
    return 2 * rows * d * f, e * (rows * d + used * d * f + rows * f)


def attention_call_bound(span, args, kwargs, grad):
    """The bound of one call the attention spans wrap, from its tensors'
    shapes: the forward `core_attention(qg (B,S,KVH,G,D), k, v, causal=)`
    (writing each row's log-sum-exp when it runs under grad) or the
    backward `flash_attention_bwd(q (B,H,S,D), k (B,KVH,S,D), ...)`."""
    causal = kwargs.get("causal", True)
    if span.endswith("_bwd"):
        B, H, S, D = args[0].shape
        flops, nbytes = attention_bwd_work(B, H, args[1].shape[1], S, D,
                                           causal)
    else:
        B, S, KVH, G, D = args[0].shape
        flops, nbytes = attention_fwd_work(B, KVH * G, KVH, S, D, causal,
                                           lse=grad)
    return bound_s(flops, nbytes)
