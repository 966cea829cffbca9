"""Public grouped-matmul wrapper (the port of src/repro/kernels/gmm/ops.py).
The reference pads C, d and f to tile multiples and slices the result;
the CUDA kernel masks the ragged edges itself, so this layer only casts
w to x's dtype."""
from repro_torch.kernels.gmm.kernel import gmm_ecd


def gmm(x, w, rows=None):
    """x: (E,C,d) @ w: (E,d,f) -> (E,C,f), per expert; rows: each expert's
    count of rows of x that hold input, or None (see `gmm_ecd`)."""
    return gmm_ecd(x.contiguous(), w.to(x.dtype).contiguous(), rows)
