"""Plain PyTorch grouped (per-expert) matmul; follows
src/repro/kernels/gmm/ref.py expression by expression."""
import torch


def gmm_ref(x, w, rows=None):
    """x: (E,C,d); w: (E,d,f) -> (E,C,f), f32 math, in x's dtype. rows:
    None, or (E,) counts: x's rows at or past rows[e] are taken as zero
    (never read), so the output rows there are zero."""
    if rows is not None:
        held = torch.arange(x.shape[1], device=x.device) < rows[:, None]
        x = torch.where(held[..., None], x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
