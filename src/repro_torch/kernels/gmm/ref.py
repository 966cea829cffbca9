"""Plain PyTorch grouped (per-expert) matmul; follows
src/repro/kernels/gmm/ref.py expression by expression."""
import torch


def gmm_ref(x, w):
    """x: (E,C,d); w: (E,d,f) -> (E,C,f), f32 math, in x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
