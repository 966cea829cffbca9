"""Public chunked-WKV wrapper (the port of src/repro/kernels/wkv6/ops.py).
The reference pads T to a multiple of the chunk, casts to f32, starts
from a zero state and returns y; here the kernel masks the ragged last
chunk itself, and the state is carried in and out, as the model's time
mix needs it."""
from repro_torch.kernels.wkv6.kernel import wkv6_btHN


def wkv6(r, k, v, logw, u, chunk=64, state=None):
    """r,k,v,logw: (B,T,H,N); u: (H,N); state: (B,H,N,N) f32 or None
    (zeros). Returns (y (B,T,H,N) f32, final S); a given state is written
    over with the final S, which is then that tensor."""
    r, k, v, logw, u = (a.float().contiguous() for a in (r, k, v, logw, u))
    return wkv6_btHN(r, k, v, logw, u, state, chunk=chunk)
