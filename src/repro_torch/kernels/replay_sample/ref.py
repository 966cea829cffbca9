"""Plain PyTorch fused prioritized sampling (Ape-X, survey §3.1) and the
sharded replay service's per-shard draw; follows
src/repro/kernels/replay_sample/ref.py expression by expression.

    logits_i = α log(p_i + ε)            (masked to filled slots)
    draw:      top-n of logits_i + g_i   (g_i ~ Gumbel(0,1) given by the
               caller: Gumbel-top-k, sampling WITHOUT replacement
               proportional to p_i^α)
    weights:   w_j ∝ (N π_{idx_j})^{-β}, normalized to max 1, with π
               gathered from the chosen logits and one scalar partition
               function.

`lax.top_k` breaks ties toward the lower index and `torch.topk` promises
no order among ties, so the top n come from a stable descending sort:
equal scores keep index order, and the −inf slots past `size` come last
in index order, as in the reference.
"""
import torch


def prioritized_sample_ref(prio, size, gumbel, n, alpha=0.6, beta=0.4,
                           eps=1e-6):
    """prio (C,) raw priorities, size int32 scalar tensor (filled slots),
    gumbel (C,) standard Gumbel noise. Returns (idx (n,) int32, w (n,)
    f32). With n > size the surplus positions repeat the top draw and its
    real weight; an unfilled slot is never returned."""
    C = prio.shape[0]
    nvalid = torch.clamp(torch.as_tensor(size, device=prio.device), min=1)
    valid = torch.arange(C, device=prio.device) < nvalid
    logits = torch.where(valid, alpha * torch.log(prio + eps), -torch.inf)
    scores = torch.where(valid, logits + gumbel, -torch.inf)
    idx = torch.sort(scores, descending=True, stable=True).indices[:n]
    idx = torch.where(torch.arange(n, device=prio.device) < nvalid, idx,
                      idx[0]).to(torch.int32)
    return idx, prioritized_weights_ref(prio, size, idx, alpha, beta, eps)


def prioritized_weights_ref(prio, size, idx, alpha=0.6, beta=0.4,
                            eps=1e-6):
    """IS weights for already-chosen slots `idx` (n,) against the full
    (C,) priority vector: the weight half of prioritized_sample_ref."""
    C = prio.shape[0]
    nvalid = torch.clamp(torch.as_tensor(size, device=prio.device), min=1)
    valid = torch.arange(C, device=prio.device) < nvalid
    logits = torch.where(valid, alpha * torch.log(prio + eps), -torch.inf)
    # π_idx without materializing softmax(logits): gather the chosen
    # logits, normalize by the (scalar) partition function
    m = torch.max(logits)
    Z = torch.sum(torch.where(valid, torch.exp(logits - m), 0.0))
    p = torch.exp(logits[idx] - m) / Z
    w = (nvalid * p + 1e-12) ** (-beta)
    return w / torch.clamp(w.max(), min=1e-12)


def shard_gumbel_topk_ref(prio, nvalid_local, gumbel, k, alpha=0.6,
                          eps=1e-6):
    """The per-shard half of the sharded draw: the top-k (score, local
    index) pairs over one shard's (chunk,) priorities and Gumbel noise.
    Returns (scores (k,) f32 descending, idx (k,) int32).

    `nvalid_local` counts the filled slots IN THIS SHARD; the caller keeps
    the global max(size, 1) guard, so there is no local guard and an empty
    shard gives only -inf candidates (idx = position). The masking and
    score expressions are prioritized_sample_ref's, so the shards' scores
    side by side are the flat score vector bitwise."""
    C = prio.shape[-1]
    valid = torch.arange(C, device=prio.device) < nvalid_local
    logits = torch.where(valid, alpha * torch.log(prio + eps), -torch.inf)
    scores = torch.where(valid, logits + gumbel, -torch.inf)
    s, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], idx[..., :k].to(torch.int32)


def shard_gumbel_topk_stack_ref(prio, nvalid, gumbel, k, alpha=0.6,
                                eps=1e-6):
    """`shard_gumbel_topk_ref` row by row over an (R, chunk) stack of
    shards with their local counts `nvalid` (R,). Returns (scores (R, k),
    idx (R, k) int32)."""
    nvalid = torch.as_tensor(nvalid, device=prio.device)
    return shard_gumbel_topk_ref(prio, nvalid[:, None], gumbel, k, alpha,
                                 eps)
