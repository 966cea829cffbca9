"""ctypes bindings of the Hopper replay-draw kernels (csrc/replay_sample.cu):
`prioritized_sample_c` and `shard_topk_c`, the ports of the Pallas kernels
of the same names, both a radix select.

A CUDA tensor launches the kernel (one select level, more for a buffer or
shard above 16384 slots; each call counted as one launch of the op) or
raises; a CPU tensor takes the plain version (ref.py). Each function's
`.launches` counts its launches, so a run can show that its main path
went through the kernel. `size` and `nvalid` stay on the device, as the
Pallas kernels take them as arrays: reading them on the host would sync
once per draw.
"""
import ctypes
import functools

import torch

from repro_torch.kernels.common import (check_launch, count_launch,
                                        launch_stream, load_kernels, on_device)
from repro_torch.kernels.replay_sample.ref import (
    prioritized_sample_ref, shard_gumbel_topk_stack_ref)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_N = 1024                # the kernel's kMaxN
MAX_SHARDS = 65535          # the grid's y limit
MAX_CHUNK = 4096 * 1024     # the kernel's kMaxChunk: slots of a draw or shard
SELECT_TILE = 16384         # the kernel's kSelTile: one launch up to it


@functools.cache
def _launcher():
    dll = load_kernels()
    fn = dll.prioritized_sample_c
    fn.argtypes = [_P, _P, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P]
    fn.restype = _I
    shard = dll.shard_topk_c
    shard.argtypes = [_P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P]
    shard.restype = _I
    for name, args in (("shard_topk_workspace", [_I, _I, _I]),
                       ("prioritized_sample_workspace", [_I, _I])):
        getattr(dll, name).argtypes = args
        getattr(dll, name).restype = ctypes.c_longlong
    return dll, fn


def _check(prio, gumbel, size, n):
    """Raise on what `prioritized_sample_c` does not take."""
    C = prio.shape[0]
    dev = prio.device
    for name, t, dtype in (("prio", prio, torch.float32),
                           ("gumbel", gumbel, torch.float32),
                           ("size", size, torch.int32)):
        if t.dtype != dtype:
            raise ValueError(f"prioritized_sample_c: {name} must be {dtype}, "
                             f"got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"prioritized_sample_c: {name} on {t.device}, "
                             f"prio on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"prioritized_sample_c: {name} is not "
                             f"contiguous")
    if prio.ndim != 1 or tuple(gumbel.shape) != (C,) or size.numel() != 1:
        raise ValueError(f"prioritized_sample_c: expected prio and gumbel "
                         f"(C,) and one size, got {tuple(prio.shape)}, "
                         f"{tuple(gumbel.shape)}, {tuple(size.shape)}")
    if not 1 <= n <= min(C, MAX_N):
        raise ValueError(f"prioritized_sample_c: n={n} outside [1, "
                         f"min(C={C}, {MAX_N})]")


@functools.lru_cache(maxsize=64)
def buffer_words(C, n):
    """The 4-byte words of `prioritized_sample_c`'s one allocation: the
    outputs idx, w (n each), then the workspace the kernel asks for (the
    select levels' candidates and the first level's partials)."""
    if C > MAX_CHUNK:
        raise ValueError(f"prioritized_sample_c: C={C} above {MAX_CHUNK} "
                         f"slots")
    dll, _ = _launcher()
    return 2 * n + dll.prioritized_sample_workspace(C, n)


def _args(prio, gumbel, size, n, alpha, beta, eps, buf):
    """The C launcher's arguments but the stream, over `buf` of
    buffer_words(C, n) words."""
    ptr = buf.data_ptr()
    return (prio.data_ptr(), gumbel.data_ptr(), size.data_ptr(),
            prio.shape[0], n, float(alpha), float(beta), float(eps),
            ptr + 8 * n, ptr, ptr + 4 * n)


def prioritized_sample_c(prio, gumbel, size, n, alpha=0.6, beta=0.4,
                         eps=1e-6):
    """prio, gumbel (C,) f32 contiguous; size an int32 tensor of one
    element on their device. Returns (idx (n,) int32, w (n,) f32)."""
    if not prio.is_cuda:
        return prioritized_sample_ref(prio, size, gumbel, n, alpha, beta,
                                      eps)
    _check(prio, gumbel, size, n)
    dll, fn = _launcher()
    # one allocation: the outputs idx, w and the workspace
    buf = torch.empty((buffer_words(prio.shape[0], n),), dtype=torch.int32,
                      device=prio.device)
    with on_device(prio.device):
        code = fn(*_args(prio, gumbel, size, n, alpha, beta, eps, buf),
                  launch_stream(prio.device))
    count_launch(prioritized_sample_c)
    check_launch(dll, code, "prioritized_sample_c")
    return buf[:n], buf[n:2 * n].view(torch.float32)


prioritized_sample_c.launches = 0


def shard_topk_c(prio, gumbel, nvalid, k, alpha=0.6, eps=1e-6):
    """prio, gumbel (R, chunk) f32 contiguous; nvalid (R,) int32 on their
    device, each shard's LOCAL filled count. Returns (scores (R, k) f32,
    idx (R, k) int32): per shard the top k in (score desc, index asc)
    order, (-inf, position) past the shard's count."""
    if not prio.is_cuda:
        return shard_gumbel_topk_stack_ref(prio, nvalid, gumbel, k, alpha,
                                           eps)
    dev = prio.device
    for name, t, dtype in (("prio", prio, torch.float32),
                           ("gumbel", gumbel, torch.float32),
                           ("nvalid", nvalid, torch.int32)):
        if t.dtype != dtype:
            raise ValueError(f"shard_topk_c: {name} must be {dtype}, got "
                             f"{t.dtype}")
        if t.device != dev:
            raise ValueError(f"shard_topk_c: {name} on {t.device}, prio on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"shard_topk_c: {name} is not contiguous")
    if prio.ndim != 2 or gumbel.shape != prio.shape or \
            tuple(nvalid.shape) != (prio.shape[0],):
        raise ValueError(f"shard_topk_c: expected prio and gumbel (R, chunk) "
                         f"and nvalid (R,), got {tuple(prio.shape)}, "
                         f"{tuple(gumbel.shape)}, {tuple(nvalid.shape)}")
    R, chunk = prio.shape
    if not 1 <= R <= MAX_SHARDS:
        raise ValueError(f"shard_topk_c: R={R} outside [1, {MAX_SHARDS}]")
    if not 1 <= k <= min(chunk, MAX_N):
        raise ValueError(f"shard_topk_c: k={k} outside [1, min(chunk={chunk}"
                         f", {MAX_N})]")
    if chunk > MAX_CHUNK:
        raise ValueError(f"shard_topk_c: chunk={chunk} above {MAX_CHUNK} "
                         f"slots")
    dll, _ = _launcher()
    # one allocation of 4-byte words for the outputs scores, idx; the
    # select levels before the last (shards above SELECT_TILE slots) take
    # a workspace for their candidates
    buf = torch.empty((2, R, k), dtype=torch.int32, device=dev)
    scores, idx = buf[0].view(torch.float32), buf[1]
    ws = None
    if chunk > SELECT_TILE:
        ws = torch.empty((dll.shard_topk_workspace(R, chunk, k),),
                         dtype=torch.int32, device=dev)
    with on_device(dev):
        stream = launch_stream(dev)
        code = dll.shard_topk_c(prio.data_ptr(), gumbel.data_ptr(),
                                nvalid.data_ptr(), R, chunk, k, float(alpha),
                                float(eps),
                                None if ws is None else ws.data_ptr(),
                                scores.data_ptr(), idx.data_ptr(), stream)
    count_launch(shard_topk_c)
    check_launch(dll, code, "shard_topk_c")
    return scores, idx


shard_topk_c.launches = 0
