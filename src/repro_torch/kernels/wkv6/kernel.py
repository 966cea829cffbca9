"""ctypes binding of the Hopper chunked-WKV kernel (csrc/wkv6.cu), the
port of the Pallas `wkv6_btHN`, extended as the model path needs it: an
optional initial state in and the final state out.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version (ref.py). `wkv6_btHN.launches` counts kernel launches, so a
run can show that its main path went through the kernel.

The kernel reads r, k, v and u as float32 or bfloat16 (each its own) and
converts them in registers, so the model hands over its bf16 activations
without a cast; logw and the state are float32. The launch arguments go
to the C side as one packed struct (the layout of `WkvParams` in the
source).
"""
import ctypes
import functools
import struct

import torch

from repro_torch.kernels.common import (check_launch, count_launch,
                                        launch_stream, load_kernels, on_device)
from repro_torch.kernels.wkv6.ref import wkv6_ref

MAX_N = MAX_CHUNK = 64
_F32, _BF16 = torch.float32, torch.bfloat16
# WkvParams: r, k, v, logw, u, s0, y, s_out; B, T, H, N, chunk; dtypes (bit
# 0..3: r, k, v, u in bf16)
PARAMS = struct.Struct("<8Q6i")
_NAMES = ("r", "k", "v", "logw", "u", "state")


@functools.cache
def _launcher():
    dll = load_kernels()
    fn = dll.wkv6_btHN
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return dll, fn


def _dtype_ok(name, dt):
    return dt == _F32 or (dt == _BF16 and name in ("r", "k", "v", "u"))


def _refuse(r, k, v, logw, u, state):
    """Raise the first error of the full per-tensor walk (the fast check
    in `_check` found one)."""
    if r.ndim != 4:
        raise ValueError(f"wkv6_btHN: r must be (B,T,H,N), got "
                         f"{tuple(r.shape)}")
    B, T, H, N = r.shape
    want = {"r": (B, T, H, N), "k": (B, T, H, N), "v": (B, T, H, N),
            "logw": (B, T, H, N), "u": (H, N), "state": (B, H, N, N)}
    for name, t in zip(_NAMES, (r, k, v, logw, u, state)):
        if t is None:
            continue
        if tuple(t.shape) != want[name]:
            raise ValueError(f"wkv6_btHN: {name} is {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if not _dtype_ok(name, t.dtype):
            kinds = ("float32 or bfloat16" if name in ("r", "k", "v", "u")
                     else "float32")
            raise ValueError(f"wkv6_btHN: {name} is {t.dtype}, expected "
                             f"{kinds}")
        if t.device != r.device:
            raise ValueError(f"wkv6_btHN: {name} on {t.device}, r on "
                             f"{r.device}")
        if not t.is_contiguous():
            raise ValueError(f"wkv6_btHN: {name} must be contiguous")
    raise ValueError("wkv6_btHN: inputs the kernel does not take")


def _check(r, k, v, logw, u, state, chunk):
    """Raise on what the kernel does not take; returns the dtype bits.
    One pass of cheap tests; on a failure `_refuse` finds which tensor
    and raises its error."""
    if torch.is_grad_enabled() and (
            r.requires_grad or k.requires_grad or v.requires_grad
            or logw.requires_grad or u.requires_grad
            or (state is not None and state.requires_grad)):
        # the kernel writes through ctypes: its outputs have no grad_fn
        raise RuntimeError(
            "wkv6_btHN: an input requires grad, but there is no WKV "
            "backward kernel: the reference trains its LMs without kernels "
            "(use_kernels=False, as launch/train.py does), and backward "
            "kernels wait in ROADMAP queue 2; run under torch.no_grad() / "
            "inference_mode to serve")
    shape = r.shape
    if len(shape) != 4:
        _refuse(r, k, v, logw, u, state)
    B, T, H, N = shape
    dev = r.get_device()
    ok = (k.shape == shape and v.shape == shape and logw.shape == shape
          and u.shape == (H, N) and logw.dtype == _F32
          and k.get_device() == dev and v.get_device() == dev
          and logw.get_device() == dev and u.get_device() == dev
          and r.is_contiguous() and k.is_contiguous() and v.is_contiguous()
          and logw.is_contiguous() and u.is_contiguous())
    bits = 0
    for i, t in enumerate((r, k, v, u)):
        if t.dtype == _BF16:
            bits |= 1 << i
        elif t.dtype != _F32:
            ok = False
    if state is not None:
        ok = ok and (state.shape == (B, H, N, N) and state.dtype == _F32
                     and state.get_device() == dev
                     and state.is_contiguous())
    if not ok:
        _refuse(r, k, v, logw, u, state)
    if not (1 <= N <= MAX_N and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"wkv6_btHN: N = {N}, chunk = {chunk}; the kernel "
                         f"takes 1 <= N <= {MAX_N}, 1 <= chunk <= "
                         f"{MAX_CHUNK}")
    if not (1 <= B <= 65535 and 1 <= T < 2 ** 31 and 1 <= H < 2 ** 31):
        raise ValueError(f"wkv6_btHN: (B,T,H) = {(B, T, H)} outside "
                         f"1 <= B <= 65535, 1 <= T, H < 2^31")
    return bits


def wkv6_btHN(r, k, v, logw, u, state=None, *, chunk=64):
    """r,k,v: (B,T,H,N) and u: (H,N), f32 or bf16; logw: (B,T,H,N) f32;
    state: (B,H,N,N) f32 or None (zeros); all contiguous. Returns (y
    (B,T,H,N) f32, final S (B,H,N,N) f32). With T or `chunk` below 16
    the kernel runs the per-step recurrence; else it carries the state
    across chunks of the largest multiple of `chunk` up to 64 steps (the
    ragged last chunk masked in the kernel). A given state is written
    over with the final S, and returned as S; with None, S is a new
    tensor."""
    if not r.is_cuda:  # the f32 function of the values, as the kernel
        y, S = wkv6_ref(r.float(), k.float(), v.float(), logw.float(),
                        u.float(), state)
        return y, (S if state is None else state.copy_(S))
    bits = _check(r, k, v, logw, u, state, chunk)
    B, T, H, N = r.shape
    y = torch.empty(r.shape, dtype=_F32, device=r.device)
    S = state
    if S is None:
        S = torch.empty((B, H, N, N), dtype=_F32, device=r.device)
    params = PARAMS.pack(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), 0 if state is None else state.data_ptr(),
        y.data_ptr(), S.data_ptr(), B, T, H, N, chunk, bits)
    dll, fn = _launcher()
    with on_device(r.device):
        code = fn(params, launch_stream(r.device))
    count_launch(wkv6_btHN)
    check_launch(dll, code, "wkv6_btHN")
    return y, S


wkv6_btHN.launches = 0
