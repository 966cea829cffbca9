"""ctypes binding of the Hopper chunked-WKV kernel (csrc/wkv6.cu), the
port of the Pallas `wkv6_btHN`, extended as the model path needs it: an
optional initial state in and the final state out.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version (ref.py). `wkv6_btHN.launches` counts kernel launches, so a
run can show that its main path went through the kernel.
"""
import ctypes
import functools

import torch

from repro_torch.kernels.common import (check_launch, launch_stream,
                                        load_kernels, on_device)
from repro_torch.kernels.wkv6.ref import wkv6_ref

MAX_N = MAX_CHUNK = 64


@functools.cache
def _launcher():
    dll = load_kernels()
    fn = dll.wkv6_btHN
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return dll, fn


def _check(r, k, v, logw, u, state, chunk):
    ins = {"r": r, "k": k, "v": v, "logw": logw, "u": u}
    if state is not None:
        ins["state"] = state
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins.values()):
        # the kernel writes through ctypes: its outputs have no grad_fn
        raise RuntimeError(
            "wkv6_btHN: an input requires grad, but no WKV backward kernel "
            "is ported (the reference has none; RWKV training is a later "
            "slice); run under torch.no_grad() / inference_mode, or use "
            "use_kernels=False")
    if r.ndim != 4:
        raise ValueError(f"wkv6_btHN: r must be (B,T,H,N), got "
                         f"{tuple(r.shape)}")
    B, T, H, N = r.shape
    want = {"r": (B, T, H, N), "k": (B, T, H, N), "v": (B, T, H, N),
            "logw": (B, T, H, N), "u": (H, N), "state": (B, H, N, N)}
    for name, t in ins.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"wkv6_btHN: {name} is {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if t.dtype != torch.float32:
            raise ValueError(f"wkv6_btHN: {name} is {t.dtype}, expected "
                             f"float32")
        if t.device != r.device:
            raise ValueError(f"wkv6_btHN: {name} on {t.device}, r on "
                             f"{r.device}")
        if not t.is_contiguous():
            raise ValueError(f"wkv6_btHN: {name} must be contiguous")
    if not (1 <= N <= MAX_N and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"wkv6_btHN: N = {N}, chunk = {chunk}; the kernel "
                         f"takes 1 <= N <= {MAX_N}, 1 <= chunk <= "
                         f"{MAX_CHUNK}")
    if not (1 <= B <= 65535 and 1 <= T < 2 ** 31 and 1 <= H < 2 ** 31):
        raise ValueError(f"wkv6_btHN: (B,T,H) = {(B, T, H)} outside "
                         f"1 <= B <= 65535, 1 <= T, H < 2^31")


def wkv6_btHN(r, k, v, logw, u, state=None, *, chunk=64):
    """r,k,v,logw: (B,T,H,N) f32 contiguous; u: (H,N); state: (B,H,N,N)
    or None (zeros). Returns (y (B,T,H,N) f32, final S (B,H,N,N) f32),
    chunked by `chunk` steps (the ragged last chunk masked in the kernel).
    A given state is written over with the final S, and returned as S;
    with None, S is a new tensor."""
    if not r.is_cuda:
        y, S = wkv6_ref(r, k, v, logw, u, state)
        return y, (S if state is None else state.copy_(S))
    _check(r, k, v, logw, u, state, chunk)
    B, T, H, N = r.shape
    y = torch.empty_like(r)
    S = state
    if S is None:
        S = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    dll, fn = _launcher()
    with on_device(r.device):
        stream = launch_stream(r.device)
        code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                  u.data_ptr(), None if state is None else state.data_ptr(),
                  y.data_ptr(), S.data_ptr(), B, T, H, N, chunk, stream)
    wkv6_btHN.launches += 1
    check_launch(dll, code, "wkv6_btHN")
    return y, S


wkv6_btHN.launches = 0
