"""Public chunked-WKV wrapper (the port of src/repro/kernels/wkv6/ops.py).
The reference pads T to a multiple of the chunk, casts to f32, starts
from a zero state and returns y; here the kernel masks the ragged last
chunk itself, reads f32 or bf16 r, k, v and u as they are (the
reference's cast, fused into its loads), and the state is carried in and
out, as the model's time mix needs it."""
import torch

from repro_torch.kernels.wkv6.kernel import wkv6_btHN

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _as_kernel_input(a):
    """`a` itself where the kernel reads it (f32 or bf16, contiguous),
    else its contiguous f32 copy."""
    if a.dtype in _KERNEL_DTYPES and a.is_contiguous():
        return a
    return a.float().contiguous()


def wkv6(r, k, v, logw, u, chunk=64, state=None):
    """r,k,v,logw: (B,T,H,N); u: (H,N); state: (B,H,N,N) f32 or None
    (zeros). Returns (y (B,T,H,N) f32, final S); a given state is written
    over with the final S, which is then that tensor."""
    if r.is_cuda:
        r, k, v, u = (_as_kernel_input(a) for a in (r, k, v, u))
        if logw.dtype != torch.float32 or not logw.is_contiguous():
            logw = logw.float().contiguous()
    else:
        r, k, v, logw, u = (a.float().contiguous()
                            for a in (r, k, v, logw, u))
    return wkv6_btHN(r, k, v, logw, u, state, chunk=chunk)
