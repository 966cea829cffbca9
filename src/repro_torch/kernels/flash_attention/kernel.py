"""ctypes binding of the Hopper flash-attention kernels: the forward
(csrc/flash_attention.cu), the port of the Pallas `flash_attention_hsd`,
and its f32 short-span backward (csrc/flash_attention_bwd.cu), which the
reference does not have (it trains through the jnp oracle).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version (ref.py). Each wrapper counts its kernel launches, so a
run can show that its main path went through the kernel:
`flash_attention_hsd.launches` the forward's (both forward-only entries
below), `flash_attention_fwd_lse.launches` the training forward's (the
same kernel, writing each row's log-sum-exp) and
`flash_attention_bwd.launches` the backward's. The two forward-only
entries raise under grad; training goes through the autograd Function
in ops.py, which launches the last two.

The launch arguments go to the C side as one packed struct (the layout
of `FlashParams` in the source): one ctypes argument instead of 27 cuts
the host time per call, which at the LM prefill shapes is what the
call's time is made of (launch/profile_host_cost.py).
"""
import ctypes
import functools
import struct

import torch

from repro_torch.kernels.common import (check_launch, count_launch,
                                        launch_stream, load_kernels, on_device)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                    attention_lse_ref,
                                                    attention_ref)

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# FlashParams: q, k, v, o; kind, B, H, KVH, S, D, causal, window, kv_end;
# scale; the (b, h, s) element strides of q, k, v, o; lse (0: none)
PARAMS = struct.Struct("<4Q9if12qQ")
# FlashBwdParams: q, k, v, o, dO, lse, dq, dk, dv; B, H, KVH, S, D,
# causal, window, kv_end; scale (4 bytes of padding); the (b, h, s)
# element strides of q, k, v, o, dO, dq, dk, dv
BWD_PARAMS = struct.Struct("<9Q8if4x24q")
SHORT_SPAN = 32     # the longest key range the short-span kernels take
_SHORT_ROWS = 16    # rows of a block of it (flash_attention.cu kShortRows)
_GRID_X = 2 ** 31 - 1


def kernel_kind(dt, kv_end, B, KVH, S, G):
    """The kernel a call takes, as FlashParams' `kind`: 2, the short-span
    kernels, for float32 (`dt` 0) when every row's keys lie in [0, kv_end)
    with kv_end <= 32, one tile of keys (every policy-trunk call), and
    the grid of at most B * KVH * ceil(S * G / 16) blocks fits (the C side
    takes flash_short_reg_f32 up to 4 keys at D <= 128, else
    flash_short_f32); else 0 (flash_fwd<float>) for float32 and 1 for
    bfloat16 (flash_fwd_tc, or flash_fwd in bf16 for operands cp.async
    cannot read)."""
    if dt != 0:
        return 1
    if kv_end <= SHORT_SPAN and \
            B * KVH * -(-S * G // _SHORT_ROWS) <= _GRID_X:
        return 2
    return 0


@functools.cache
def _launcher(entry="flash_attention_hsd"):
    dll = load_kernels()
    fn = getattr(dll, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return dll, fn


def _no_grad(q, k, v):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # the kernel writes through ctypes: its output has no grad_fn, so
        # running it here would train without an attention gradient
        raise RuntimeError(
            "flash_attention_hsd: q, k or v requires grad, and this entry "
            "is forward-only (no backward): train through "
            "repro_torch.kernels.flash_attention.ops.flash_attention, "
            "whose autograd Function runs the backward kernel, or run "
            "under torch.no_grad() / inference_mode")


def _check_common(q, k, v, B, H, KVH, D, last_strides):
    """The checks both entries share; returns the kernel's dtype code."""
    if H % KVH:
        raise ValueError(f"flash_attention_hsd: {H} query heads do not "
                         f"group over {KVH} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_hsd: head dim {D} not in "
                         f"{HEAD_DIMS}")
    dt = _DTYPES.get(q.dtype)
    if dt is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_hsd: dtypes {q.dtype}, {k.dtype},"
                         f" {v.dtype}; expected all float32 or all bfloat16")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention_hsd: q, k, v on different devices")
    if last_strides != (1, 1, 1):
        raise ValueError("flash_attention_hsd: the head dim must be "
                         "contiguous")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention_hsd: grid dims B={B}, H={H} "
                         f"exceed 65535")
    return dt


def _check(q, k, v, valid_len):
    """Raise on what the kernel does not take for (B,H,S,D) q and
    (B,KVH,S,D) k, v; returns (dtype code, kv_end), kv_end the end of the
    keys any row may attend."""
    _no_grad(q, k, v)
    B, H, S, D = q.shape
    KVH = k.shape[1]
    if k.shape != (B, KVH, S, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention_hsd: q {tuple(q.shape)} needs "
                         f"k, v of shape (B,KVH,S,D); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    dt = _check_common(q, k, v, B, H, KVH, D,
                       (q.stride(-1), k.stride(-1), v.stride(-1)))
    kv_end = S if valid_len is None else min(int(valid_len), S)
    if kv_end < 1:
        raise ValueError(f"flash_attention_hsd: valid_len {valid_len} "
                         f"leaves no key to attend")
    return dt, kv_end


def _launch(params, device, wrapper=None, symbol="flash_attention_hsd"):
    """Launch the C entry `symbol` and count the launch on `wrapper`
    (flash_attention_hsd where not given)."""
    wrapper = wrapper or flash_attention_hsd
    dll, fn = _launcher(symbol)
    with on_device(device):
        code = fn(params, launch_stream(device))
    count_launch(wrapper)
    check_launch(dll, code, wrapper.__name__)


def flash_attention_hsd(q, k, v, *, causal=True, window=0, valid_len=None):
    """q: (B,H,S,D); k,v: (B,KVH,S,D), any strides with a contiguous head
    dim. Returns (B,H,S,D) in q's dtype: a (B,H,S,D) view of a (B,S,H,D)
    buffer, so the model layout needs no copy. No padding: a ragged S is
    masked inside the kernel; `valid_len` masks keys at or past it."""
    if not q.is_cuda:
        return attention_ref(q, k, v, causal=causal, window=window,
                             valid_len=valid_len)
    dt, kv_end = _check(q, k, v, valid_len)
    B, H, S, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    KVH = k.shape[1]
    _launch(PARAMS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kernel_kind(dt, kv_end, B, KVH, S, H // KVH), B, H, KVH, S, D,
        int(causal), int(window), kv_end, D ** -0.5,
        qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
        S * H * D, D, H * D, 0), q.device)
    return out.transpose(1, 2)


flash_attention_hsd.launches = 0


def _short_f32(name, dt, kv_end, B, KVH, S, G):
    """Raise unless the call takes the f32 short-span kernels (the only
    ones with a backward)."""
    if kernel_kind(dt, kv_end, B, KVH, S, G) != 2:
        raise ValueError(
            f"{name}: the backward covers float32 with key spans <= "
            f"{SHORT_SPAN} (got {'float32' if dt == 0 else 'bfloat16'}, "
            f"{kv_end} keys, B={B}, KVH={KVH}); the reference trains its "
            f"LMs without kernels (use_kernels=False), and other backward "
            f"kernels wait in ROADMAP queue 2")


def flash_attention_fwd_lse(q, k, v, *, causal=True, window=0,
                            valid_len=None):
    """The training forward: flash_attention_hsd's kernel on float32
    with key spans <= 32, also writing each row's log-sum-exp. q:
    (B,H,S,D); k, v: (B,KVH,S,D), any strides with a contiguous head dim.
    Returns (o, lse): o (B,H,S,D), a view of a (B,S,H,D) buffer, bitwise
    flash_attention_hsd's; lse (B,H,S) float32, -inf for a row with no
    key. No graph is recorded (the autograd Function in ops.py calls
    it)."""
    if not q.is_cuda:
        return attention_lse_ref(q, k, v, causal=causal, window=window,
                                 valid_len=valid_len)
    dt, kv_end = _check(q, k, v, valid_len)
    B, H, S, D = q.shape
    KVH = k.shape[1]
    _short_f32("flash_attention_fwd_lse", dt, kv_end, B, KVH, S, H // KVH)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    _launch(PARAMS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        2, B, H, KVH, S, D, int(causal), int(window), kv_end, D ** -0.5,
        qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
        S * H * D, D, H * D, lse.data_ptr()), q.device,
        flash_attention_fwd_lse)
    return out.transpose(1, 2), lse


flash_attention_fwd_lse.launches = 0


def _bwd_operands_error(q, o, lse, do, B, H, S):
    """flash_attention_bwd's message for the operand it refuses."""
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != torch.float32 or \
                t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd: {name} must be float32 "
                             f"{tuple(q.shape)} on {q.device} with a "
                             f"contiguous head dim")
    raise ValueError(f"flash_attention_bwd: lse must be contiguous "
                     f"float32 {(B, H, S)} on {q.device}")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0,
                        valid_len=None):
    """The backward of flash_attention_fwd_lse on float32, key spans
    <= 32: q, o, do (B,H,S,D), k, v (B,KVH,S,D), any strides with a
    contiguous head dim, lse (B,H,S) as the forward wrote it. Returns
    (dq, dk, dv): dq (B,H,S,D), a view of a (B,S,H,D) stretch, and dk, dv
    (B,KVH,S,D), views of (B,S,KVH,D) stretches, of one buffer (the model
    layout needs no copy; one allocation, not three). Deterministic: dk
    and dv are summed over each kv head's group in one fixed order,
    without atomics."""
    if not q.is_cuda:
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window, valid_len=valid_len)
    dt, kv_end = _check(q, k, v, valid_len)
    B, H, S, D = q.shape
    KVH = k.shape[1]
    _short_f32("flash_attention_bwd", dt, kv_end, B, KVH, S, H // KVH)
    # q's dtype, device and head-dim stride passed _check: o, do and lse
    # are held to them in one pass (get_device() is an int, cheaper than
    # comparing devices), and the message is found only on a refusal
    f32, dev, shape = torch.float32, q.get_device(), q.shape
    if o.shape != shape or do.shape != shape or lse.shape != (B, H, S) or \
            o.dtype != f32 or do.dtype != f32 or lse.dtype != f32 or \
            o.get_device() != dev or do.get_device() != dev or \
            lse.get_device() != dev or o.stride(-1) != 1 or \
            do.stride(-1) != 1 or not lse.is_contiguous():
        _bwd_operands_error(q, o, lse, do, B, H, S)
    nq, nk = B * S * H * D, B * S * KVH * D
    out = torch.empty(nq + 2 * nk, dtype=f32, device=q.device)
    ptr = out.data_ptr()
    qs, ks, vs, os_, ds = (t.stride() for t in (q, k, v, o, do))
    _launch(BWD_PARAMS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), ptr, ptr + 4 * nq,
        ptr + 4 * (nq + nk), B, H, KVH, S, D, int(causal), int(window),
        kv_end, D ** -0.5, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2],
        vs[0], vs[1], vs[2], os_[0], os_[1], os_[2], ds[0], ds[1], ds[2],
        S * H * D, D, H * D, S * KVH * D, D, KVH * D,
        S * KVH * D, D, KVH * D), q.device, flash_attention_bwd,
        "flash_attention_bwd")
    kv = (S * KVH * D, D, KVH * D, 1)
    return (out.as_strided((B, H, S, D), (S * H * D, D, H * D, 1)),
            out.as_strided((B, KVH, S, D), kv, nq),
            out.as_strided((B, KVH, S, D), kv, nq + nk))


flash_attention_bwd.launches = 0


def grouped_params(qg, k, v, out, causal, window):
    """Check the model layout, qg (B,S,KVH,G,D) and k, v, out
    (B,S,KVH,D), (B,S,KVH,G,D) with out contiguous, and pack the launch
    arguments: query head h = kvh * G + g reads kv head kvh, and the
    strides index the tensors as they lie (no view, no copy). Returns
    None where q's (KVH, G) dims do not fold into one head stride."""
    _no_grad(qg, k, v)
    B, S, KVH, G, D = qg.shape
    if k.shape != (B, S, KVH, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: qg {tuple(qg.shape)} needs k, v "
                         f"of shape (B,S,KVH,D); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    H = KVH * G
    qs, ks, vs = qg.stride(), k.stride(), v.stride()
    dt = _check_common(qg, k, v, B, H, KVH, D, (qs[4], ks[3], vs[3]))
    if G == 1:
        q_h = qs[2]
    elif KVH == 1 or qs[2] == G * qs[3]:
        q_h = qs[3]
    else:
        return None
    return PARAMS.pack(
        qg.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kernel_kind(dt, S, B, KVH, S, G), B, H, KVH, S, D, int(causal),
        int(window), S, D ** -0.5,
        qs[0], q_h, qs[1], ks[0], ks[2], ks[1], vs[0], vs[2], vs[1],
        S * H * D, D, H * D, 0)


def flash_attention_grouped(qg, k, v, *, causal=True, window=0):
    """The kernel on the model layout: qg (B,S,KVH,G,D), k, v (B,S,KVH,D)
    CUDA tensors with a contiguous head dim. Returns (B,S,KVH,G,D) in
    qg's dtype."""
    out = torch.empty_like(qg, memory_format=torch.contiguous_format)
    params = grouped_params(qg, k, v, out, causal, window)
    if params is None:  # (KVH, G) do not fold: a copy that does
        qg = qg.contiguous()
        params = grouped_params(qg, k, v, out, causal, window)
    _launch(params, qg.device)
    return out
