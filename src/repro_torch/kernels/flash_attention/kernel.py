"""ctypes binding of the Hopper flash-attention kernel
(csrc/flash_attention.cu), the port of the Pallas `flash_attention_hsd`.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version (ref.py). `flash_attention_hsd.launches` counts kernel
launches, so a run can show that its main path went through the kernel.
"""
import ctypes
import functools

import torch

from repro_torch.kernels.common import (check_launch, launch_stream,
                                        load_kernels, on_device)
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    dll = load_kernels()
    fn = dll.flash_attention_hsd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int64] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return dll, fn


def flash_attention_hsd(q, k, v, *, causal=True, window=0, valid_len=None):
    """q: (B,H,S,D); k,v: (B,KVH,S,D), any strides with a contiguous head
    dim. Returns (B,H,S,D) in q's dtype: a (B,H,S,D) view of a (B,S,H,D)
    buffer, so the model layout needs no copy. No padding: a ragged S is
    masked inside the kernel; `valid_len` masks keys at or past it."""
    if not q.is_cuda:
        return attention_ref(q, k, v, causal=causal, window=window,
                             valid_len=valid_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the kernel writes through ctypes: its output has no grad_fn, so
        # running it here would train without an attention gradient
        raise RuntimeError(
            "flash_attention_hsd: q, k or v requires grad, but the "
            "flash-attention backward kernel is not ported yet (it comes "
            "with --policy trunk training, ROADMAP queue 1 item 9); run "
            "under torch.no_grad() / inference_mode, or use "
            "use_kernels=False to train")
    B, H, S, D = q.shape
    KVH = k.shape[1]
    if k.shape != (B, KVH, S, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention_hsd: q {tuple(q.shape)} needs "
                         f"k, v of shape (B,KVH,S,D); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if H % KVH:
        raise ValueError(f"flash_attention_hsd: {H} query heads do not "
                         f"group over {KVH} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_hsd: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_hsd: dtypes {q.dtype}, {k.dtype},"
                         f" {v.dtype}; expected all float32 or all bfloat16")
    if not (k.device == q.device == v.device):
        raise ValueError("flash_attention_hsd: q, k, v on different devices")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_hsd: the head dim must be "
                         "contiguous")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention_hsd: grid dims B={B}, H={H} "
                         f"exceed 65535")
    kv_end = S if valid_len is None else min(int(valid_len), S)
    if kv_end < 1:
        raise ValueError(f"flash_attention_hsd: valid_len {valid_len} "
                         f"leaves no key to attend")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    o = out.transpose(1, 2)
    dll, fn = _launcher()
    with on_device(q.device):
        stream = launch_stream(q.device)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  _DTYPES[q.dtype], B, H, KVH, S, D, int(causal),
                  int(window), kv_end, D ** -0.5,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *o.stride()[:3], stream)
    flash_attention_hsd.launches += 1
    check_launch(dll, code, "flash_attention_hsd")
    return o


flash_attention_hsd.launches = 0
