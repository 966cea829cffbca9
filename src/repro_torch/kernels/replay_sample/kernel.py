"""ctypes bindings of the Hopper replay-draw kernels (csrc/replay_sample.cu):
`prioritized_sample_c` and `shard_topk_c`, the ports of the Pallas kernels
of the same names.

A CUDA tensor launches the kernel (`prioritized_sample_c`: two passes;
`shard_topk_c`: one select level, more for shards above 16384 slots;
each call counted as one launch of the op) or raises; a CPU tensor takes
the plain version (ref.py). Each
function's `.launches` counts its launches, so a run can show that its
main path went through the kernel. `size` and `nvalid` stay on the
device, as the Pallas kernels take them as arrays: reading them on the
host would sync once per draw.
"""
import ctypes
import functools

import torch

from repro_torch.kernels.common import (check_launch, launch_stream,
                                        load_kernels, on_device)
from repro_torch.kernels.replay_sample.ref import (
    prioritized_sample_ref, shard_gumbel_topk_stack_ref)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_N = 1024                # the kernel's kMaxN
MAX_BLOCKS = 1024           # the kernel's kMaxBlocks
MAX_SHARDS = 65535          # the grid's y limit
MAX_CHUNK = 4096 * 1024     # the kernel's kMaxChunk
SELECT_TILE = 16384         # the kernel's kSelTile: one launch up to it


@functools.cache
def _launcher():
    dll = load_kernels()
    fn = dll.prioritized_sample_c
    fn.argtypes = [_P, _P, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P, _P,
                   _P]
    fn.restype = _I
    shard = dll.shard_topk_c
    shard.argtypes = [_P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P]
    shard.restype = _I
    dll.shard_topk_workspace.argtypes = [_I, _I, _I]
    dll.shard_topk_workspace.restype = ctypes.c_longlong
    dll.replay_sample_tile.restype = _I
    return dll, fn, dll.replay_sample_tile()


def prioritized_sample_c(prio, gumbel, size, n, alpha=0.6, beta=0.4,
                         eps=1e-6):
    """prio, gumbel (C,) f32 contiguous; size an int32 tensor of one
    element on their device. Returns (idx (n,) int32, w (n,) f32)."""
    if not prio.is_cuda:
        return prioritized_sample_ref(prio, size, gumbel, n, alpha, beta,
                                      eps)
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
    dll, fn, tile = _launcher()
    nblocks = -(-C // tile)
    if nblocks > MAX_BLOCKS:
        raise ValueError(f"prioritized_sample_c: C={C} above "
                         f"{tile * MAX_BLOCKS} slots")
    # one allocation: outputs idx, w (n each), then the workspace: the
    # candidates' scores and indices (nblocks * n each) and the partials
    # m_b, s_b (nblocks each), all 4-byte words
    buf = torch.empty((2 * n * (nblocks + 1) + 2 * nblocks,),
                      dtype=torch.int32, device=dev)
    idx, w = buf[:n], buf[n:2 * n].view(torch.float32)
    ptr, word = buf.data_ptr(), buf.element_size()
    cand_s = ptr + word * 2 * n
    cand_i = cand_s + word * nblocks * n
    part_m = cand_i + word * nblocks * n
    with on_device(dev):
        stream = launch_stream(dev)
        code = fn(prio.data_ptr(), gumbel.data_ptr(), size.data_ptr(), C, n,
                  float(alpha), float(beta), float(eps), cand_s, cand_i,
                  part_m, part_m + word * nblocks, idx.data_ptr(),
                  w.data_ptr(), stream)
    prioritized_sample_c.launches += 1
    check_launch(dll, code, "prioritized_sample_c")
    return idx, w


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
    dll, _, _ = _launcher()
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
    shard_topk_c.launches += 1
    check_launch(dll, code, "shard_topk_c")
    return scores, idx


shard_topk_c.launches = 0
