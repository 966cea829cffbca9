"""System-architecture topologies (survey §3, Fig. 3), the port of
src/repro/core/topology.py for a group of shards held on one device.

The reference runs its collectives over a named mesh axis inside
shard_map (or vmap). Here the R members of a group live on one card as
a leading (R, ...) shard dimension of every sharded tensor, the PyTorch
form of the reference's `vmap` over the axis, so each collective becomes
an operation over that dimension:

  * `local_shard`: the scatter half (a (R * chunk,) vector viewed as
    (R, chunk), row r the member r's contiguous chunk);
  * `all_gather_shards`: its inverse, the chunks concatenated in shard
    order;
  * `psum_select`: owner-routed row assembly for the sharded replay
    service.

The gradient and param exchanges over data axes (`exchange_grads`,
`gossip_mix`), `reduce_scatter_mean`, the ZeRO-2/3 classes and
`make_distributed_step` need more than one data position and come with
the multi-device slice.
"""
from __future__ import annotations

import torch

TOPOLOGIES = ("allreduce", "ps", "gossip")


def local_shard(vec, n_shards: int):
    """A (n_shards * chunk, ...) tensor as its (n_shards, chunk, ...)
    stack of contiguous chunks: row r is what member r of the reference's
    axis holds."""
    return vec.reshape((n_shards, vec.shape[0] // n_shards)
                       + tuple(vec.shape[1:]))


def all_gather_shards(chunks):
    """Inverse of `local_shard`: the (R, chunk, ...) stack concatenated in
    shard order into one (R * chunk, ...) tensor (the reference's tiled
    all_gather)."""
    return chunks.reshape((-1,) + tuple(chunks.shape[2:]))


def psum_select(rows, own):
    """Owner-routed row assembly: `rows` (R, n, ...) is each member's
    local gather (garbage where it does not own the slot), `own` (R, n)
    bool marks the rows each member owns. Each row has exactly one owner,
    so the masked sum over the shard dimension, taken in shard order as
    the reference's psum adds, puts the true row beside zeros: x + 0 is
    exact. Bool rows ride through int32 (a sum has no bool form)."""
    mask = own.reshape(tuple(own.shape) + (1,) * (rows.ndim - 2))
    if rows.dtype == torch.bool:
        picked = torch.where(mask, rows, False).to(torch.int32)
    else:
        picked = torch.where(mask, rows, torch.zeros((), dtype=rows.dtype,
                                                     device=rows.device))
    total = picked[0]
    for r in range(1, picked.shape[0]):
        total = total + picked[r]
    return total.to(torch.bool) if rows.dtype == torch.bool else total
