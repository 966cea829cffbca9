"""System-architecture topologies (survey §3, Fig. 3), the port of
src/repro/core/topology.py for positions and shards held on one device.

The reference runs its collectives over a named mesh axis inside
shard_map (or vmap). Here the members of a group live on one card as
leading dims of a stacked tensor, the PyTorch form of the reference's
`vmap` over the axis, so each collective is a pure function over those
dims. Every sum runs in member order, one add at a time: no float
atomics, and a (1, N) or (2, N/2) nesting of the same members sums in
the same order as the flat axis.

Gradient and param exchange over data axes (the Trainer's hooks, through
`DistPlan.compile_collectives` and core/positions.py):

  * `exchange_grads(grads, topology, axis)`: ``allreduce`` (the mean
    over the members, DD-PPO/IMPALA's decentralized exchange), ``ps``
    (the parameter-server star: gather every member's gradient, then
    the mean; the same arithmetic, never fused across axes) and
    ``gossip`` (no gradient exchange);
  * `gossip_mix(params, axis, hops)`: each member averages its params
    with its ring neighbour j - 2**h, hop after hop (GALA; members stay
    ε-close, not identical);
  * `replicate_for` and `make_distributed_step`: a stacked multi-worker
    training step over a 1-D mesh (tests/test_sync_topology.py's).

The replay service's pieces (a leading (R, ...) shard dimension):

  * `local_shard`: the scatter half (a (R * chunk,) vector viewed as
    (R, chunk), row r the member r's contiguous chunk);
  * `all_gather_shards`: its inverse, the chunks concatenated in shard
    order;
  * `psum_select`: owner-routed row assembly for the sharded replay
    service.

The reference's `strip_worker_dim` / `restore_worker_dim` exist only
because shard_map keeps a length-1 dim per mesh axis on every leaf; a
position here holds its own tensors with no such dims, so they have no
counterpart. What is left to port is ZeRO learner-state sharding
(`reduce_scatter_mean`, `ZeROShardedOptimizer`, `ZeRO3Agent`; ROADMAP
queue 1, item 12).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.positions import stack_trees, tree_map

TOPOLOGIES = ("allreduce", "ps", "gossip")


def _dims(axis):
    return (axis,) if isinstance(axis, int) else tuple(axis)


def member_sum(stack):
    """The sum over the leading member dim of `stack`, in member order."""
    total = stack[0]
    for r in range(1, stack.shape[0]):
        total = total + stack[r]
    return total


def group_mean(x, axis=0):
    """Every member's copy of the mean over the group on dims `axis` (an
    int or a tuple, outermost first): members are taken row-major over
    those dims and summed in that order, then divided by their count."""
    dims = _dims(axis)
    lead = tuple(range(len(dims)))
    moved = torch.movedim(x, dims, lead)
    n = math.prod(moved.shape[:len(dims)])
    members = moved.reshape((n,) + tuple(moved.shape[len(dims):]))
    mean = member_sum(members) / n
    mean = mean.reshape((1,) * len(dims) + tuple(mean.shape))
    return torch.movedim(mean.expand(moved.shape), lead, dims)


def exchange_grads(grads, topology: str, axis=0):
    """Aggregate stacked per-member gradients (a tensor or a dict of
    them, the members on dims `axis`) according to the topology. For
    gossip the gradients come back unchanged (it mixes params)."""
    if topology in ("allreduce", "ps"):
        # ps: the star gathers every member's gradient to the centre,
        # which reduces and broadcasts the mean: the same sum, in the
        # same member order, as the all-reduce
        return tree_map(lambda g: group_mean(g, axis), grads)
    if topology == "gossip":
        return grads
    raise ValueError(topology)


def gossip_mix(params, axis: int = 0, hops: int = 1):
    """One gossip round over the ring on dim `axis` of stacked params:
    for h < hops, each member j averages with member j - 2**h (the
    reference's ppermute with perm [(i, (i + d) % n)])."""
    def mix(p):
        mixed = p
        for h in range(hops):
            nbr = torch.roll(mixed, shifts=2 ** h, dims=axis)
            mixed = 0.5 * (mixed + nbr)
        return mixed
    return tree_map(mix, params)


def replicate_for(mesh, axis, params):
    """Stack params with leading replica dim(s), one per mesh axis in
    `axis` (a name or tuple of names, outermost first)."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    shape = tuple(mesh.shape[a] for a in names)
    return tree_map(lambda p: p.expand(shape + tuple(p.shape)).clone(),
                    params)


def make_distributed_step(loss_fn, optimizer, topology: str, mesh,
                          axis: str = "workers"):
    """A multi-worker training step over the 1-D mesh axis `axis`:
    `step(params, opt_state, batch)` takes trees stacked over the axis,
    runs each worker's gradient on its batch row, exchanges them by
    `topology`, applies each worker's optimizer update and, for gossip,
    mixes params with the ring neighbour. Returns the stacked params and
    opt_state and the workers' mean loss. allreduce and ps keep the
    replicas bitwise equal; gossip lets them drift ε-close."""
    from repro_torch.core.agent import value_and_grad

    n = mesh.shape[axis]

    def step(params, opt_state, batch):
        row = lambda t, i: tree_map(lambda a: a[i], t)
        losses, grads = zip(*(value_and_grad(loss_fn, row(params, i),
                                             row(batch, i))
                              for i in range(n)))
        g = exchange_grads(stack_trees(list(grads)), topology)
        new = [optimizer.apply(row(params, i), row(opt_state, i),
                               row(g, i)) for i in range(n)]
        params = stack_trees([p for p, _ in new])
        opt_state = stack_trees([s for _, s in new])
        if topology == "gossip":
            params = gossip_mix(params)
        return params, opt_state, member_sum(torch.stack(losses)) / n

    return step


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
    total = member_sum(picked)
    return total.to(torch.bool) if rows.dtype == torch.bool else total
