"""Per-timestep scan oracle for the RWKV-6 WKV recurrence; follows
src/repro/kernels/wkv6/ref.py expression by expression."""
import torch


def wkv6_ref(r, k, v, logw, u, state=None):
    """r,k,v,logw: (B,T,H,N) f32; u: (H,N); state: (B,H,N,N) or None
    (zeros). Returns (y (B,T,H,N), S).
        y_t = r_t · (S_{t-1} + u ⊙ k_t v_tᵀ);  S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    """
    B, T, H, N = r.shape
    S = state
    if S is None:
        S = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(T):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], logw[:, t]
        kv = kt[..., :, None] * vt[..., None, :]            # (B,H,N,N)
        ys.append(torch.einsum("bhn,bhnm->bhm", rt,
                               S + u[None, :, :, None] * kv))
        S = torch.exp(lwt)[..., None] * S + kv
    return torch.stack(ys, dim=1), S
