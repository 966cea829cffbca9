"""Plain PyTorch flash attention (naive softmax, O(S^2) memory); follows
src/repro/kernels/flash_attention/ref.py expression by expression."""
import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=0, valid_len=None):
    """q: (B,H,Sq,D); k,v: (B,KVH,Sk,D); GQA by head folding (q head h
    reads kv head h // G). Float32 math, returned in q's dtype.
    `valid_len` masks key positions >= valid_len (the kernel's mask)."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    G = H // KVH
    kk = torch.repeat_interleave(k, G, dim=1).float()
    vv = torch.repeat_interleave(v, G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * D ** -0.5, kk)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos + (Sk - Sq))
    if window:
        mask = mask & (kpos > qpos + (Sk - Sq) - window)
    if valid_len is not None:
        mask = mask & (kpos < valid_len)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
