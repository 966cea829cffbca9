"""Plain PyTorch flash attention (naive softmax, O(S^2) memory); the
forward follows src/repro/kernels/flash_attention/ref.py expression by
expression. `attention_lse_ref` adds the row log-sum-exp the training
forward writes, and `attention_bwd_ref` is the backward kernel's plain
version, formula by formula (the reference has no backward of its own:
JAX differentiates its oracle)."""
import torch

NEG_INF = -1e30


def _mask(Sq, Sk, causal, window, valid_len, device):
    """(Sq, Sk) bool: the keys each query row attends."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos + (Sk - Sq))
    if window:
        mask = mask & (kpos > qpos + (Sk - Sq) - window)
    if valid_len is not None:
        mask = mask & (kpos < valid_len)
    return mask


def _scores(q, k, causal, window, valid_len):
    """Masked f32 scores (B,H,Sq,Sk) of (q D^-0.5) k, the mask, and the
    kv heads repeated over their groups."""
    D = q.shape[-1]
    G = q.shape[1] // k.shape[1]
    kk = torch.repeat_interleave(k, G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * D ** -0.5, kk)
    mask = _mask(q.shape[2], k.shape[2], causal, window, valid_len,
                 q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    return s, mask, kk


def attention_ref(q, k, v, *, causal=True, window=0, valid_len=None):
    """q: (B,H,Sq,D); k,v: (B,KVH,Sk,D); GQA by head folding (q head h
    reads kv head h // G). Float32 math, returned in q's dtype.
    `valid_len` masks key positions >= valid_len (the kernel's mask)."""
    G = q.shape[1] // k.shape[1]
    s, _, _ = _scores(q, k, causal, window, valid_len)
    vv = torch.repeat_interleave(v, G, dim=1).float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def attention_lse_ref(q, k, v, *, causal=True, window=0, valid_len=None):
    """(attention_ref's output, lse): lse (B,H,Sq) float32, the
    log-sum-exp of each row's scaled scores over its attended keys, -inf
    for a row with none (the kernel writes 0 for such a row's output and
    the plain softmax spreads it over every key: no caller has one)."""
    s, mask, _ = _scores(q, k, causal, window, valid_len)
    lse = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    return attention_ref(q, k, v, causal=causal, window=window,
                         valid_len=valid_len), lse


def attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=0,
                      valid_len=None):
    """The gradients (dq, dk, dv) of attention_ref's output with cotangent
    `do`, from the forward's o and lse (shapes as attention_ref's, lse
    (B,H,Sq)); f32 math, returned in the inputs' dtypes. A row with no
    attended key gets zero gradients."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    G = H // KVH
    scale = D ** -0.5
    s, mask, kk = _scores(q, k, causal, window, valid_len)
    vv = torch.repeat_interleave(v, G, dim=1).float()
    dof = do.float()
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)   # P
    delta = (dof * o.float()).sum(-1)                            # Δ
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)                 # Pᵀ dO
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)                # dO Vᵀ
    ds = p * (dp - delta[..., None])                             # dS
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale         # dS K
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale  # dSᵀ Q
    # sum each kv head's group of query heads
    dk = dk.reshape(B, KVH, G, Sk, D).sum(2)
    dv = dv.reshape(B, KVH, G, Sk, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
