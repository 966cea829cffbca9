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

ZeRO learner-state sharding over a `shard` (ZeRO-2) or `zero3` (ZeRO-3)
axis. The axis is a data axis too: its members are data positions, each
with its own thread and TrainState (core/positions.py). A position meets
its shard group through a `ShardAxis`, the port's `axis_index` and
`all_gather` inside shard_map: its coordinate on the axis, its own chunk
of a vector (`local_shard`), and the all-gather of its group's chunks in
shard order (`all_gather`, a `PositionGroup` collective that the Trainer
binds for the length of a fit). Unbound, as in host layout, checkpoints
and serving, a ShardAxis raises instead of gathering from itself.

  * `reduce_scatter_mean`: the stacked form (the group mean, then each
    member's own chunk); inside the Trainer the mean is already fused
    into `grad_tx`, so only the local slice runs there;
  * `ZeROShardedOptimizer` / `zero_sharded_optimizer` (ZeRO-2): the
    optimizer state lives 1/n per position, params stay whole;
  * `ZeRO3Agent` (ZeRO-3): the params and the actor ring are stored as
    chunks too and gathered per use, in `learner_step` and in
    `actor_policy`;
  * `ShardGeometry`: the layout both roles share (each entry flattened,
    padded and cut into equal chunks), the Trainer's `partition` report,
    and a shard group's optimizer-state chunks back in the params' tree
    form (`collect_opt_state`).

Every step is a per-coordinate update, a concatenation or a slice, so a
sharded fit is bitwise the replicated fit of the same positions.

The reference's `strip_worker_dim` / `restore_worker_dim` exist only
because shard_map keeps a length-1 dim per mesh axis on every leaf; a
position here holds its own tensors with no such dims, so they have no
counterpart.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.agent import TrainState, flatten_and_pad, value_and_grad
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


def reduce_scatter_mean(stack):
    """ZeRO-2's gradient exchange in the stacked form: `stack` (R, R *
    chunk) holds each member's padded vector; member r gets chunk r of
    their mean, summed in member order: (R, chunk). The same sum as the
    all-reduce, so a sharded plan stays bitwise the replicated one."""
    return local_shard(member_sum(stack) / stack.shape[0],
                       stack.shape[0])


# ---- ZeRO learner-state sharding (shard- and zero3-role axes) ---------
CHUNK = "chunk"   # the one key of an optimizer's chunk-shaped "params"


class ShardAxis:
    """A position's place on a shard-role axis: the axis `name` and
    `size`, and, while the Trainer has it bound, the position's
    coordinate `index` on it and the all-gather over its shard group."""

    def __init__(self, name: str, size: int):
        self.name = name
        self.size = size
        self.index = None
        self._gather = None

    def bind(self, index: int, gather) -> None:
        """`gather(chunks)` maps this position's list of chunks to the
        list of its group's concatenations, in shard order."""
        self.index, self._gather = index, gather

    def unbind(self) -> None:
        self.index, self._gather = None, None

    def _need(self, what):
        if self._gather is None:
            raise RuntimeError(
                f"{what} needs the shard group of axis {self.name!r}, and "
                f"this ZeRO wrapper is bound to none (host layout, a "
                f"checkpoint or serving): reassemble the state with "
                f"host_state, or run it inside Trainer.fit")

    def local_shard(self, vec):
        """This position's contiguous 1/size chunk of a padded vector."""
        self._need("local_shard")
        chunk = vec.shape[0] // self.size
        return vec[self.index * chunk:(self.index + 1) * chunk]

    def all_gather(self, chunks):
        """Inverse of `local_shard` over the group, for a list of chunks
        (one per partition entry) in one collective."""
        self._need("all_gather")
        return self._gather(list(chunks))


def _as_axis(axis, n_shards):
    return axis if isinstance(axis, ShardAxis) else ShardAxis(axis,
                                                              n_shards)


def _reorder(tree, keys):
    return {k: tree[k] for k in keys}


@dataclasses.dataclass(frozen=True)
class ShardGeometry:
    """A partition laid out over a shard axis of `n_shards` members, the
    one geometry both roles use: each entry (the whole partition, or one
    per block layer-wise) flattened and padded on its own
    (`flatten_and_pad`) and cut into `n_shards` equal chunks; member r
    holds chunk r of every entry."""
    axis: str
    n_shards: int
    keys: tuple       # the partition's key order
    sizes: tuple      # each entry's unpadded length
    chunks: tuple     # each entry's chunk length
    unravels: tuple   # each entry's unpadded vector -> its tree
    listwise: bool    # one entry per block (layer-wise ZeRO-3)

    @classmethod
    def of(cls, axis: str, n_shards: int, part, entries=None):
        """The geometry of the partition `part`, split into `entries`
        (None: one entry, the whole partition)."""
        listwise = entries is not None
        sizes, chunks, unravels = [], [], []
        for e in (entries if listwise else [part]):
            vec, size, unravel = flatten_and_pad(e, n_shards)
            sizes.append(int(size))
            chunks.append(vec.numel() // n_shards)
            unravels.append(unravel)
        return cls(axis, n_shards, tuple(part), tuple(sizes), tuple(chunks),
                   tuple(unravels), listwise)

    @property
    def n_entries(self) -> int:
        return len(self.sizes)

    @property
    def paddeds(self) -> tuple:
        return tuple(c * self.n_shards for c in self.chunks)

    def partition(self) -> dict:
        """The reference Trainer's `partition` report (ZeRO-2's keys)."""
        return {"axis": self.axis, "n_shards": self.n_shards,
                "size": sum(self.sizes), "padded": sum(self.paddeds),
                "chunk": sum(self.chunks), "listwise": self.listwise}

    def unravel(self, e: int, flat):
        """Entry e's tree from its padded vector (any leading length)."""
        return self.unravels[e](flat.reshape(-1)[:self.sizes[e]])

    def collect_opt_state(self, states, merge=None):
        """A shard group's optimizer states (chunk form, in shard order)
        as the replicated optimizer's state: every chunk-shaped entry (a
        ``{CHUNK: ...}`` dict) is concatenated over the group, trimmed of
        padding and unraveled into the params' tree form; the rest (the
        step counter) is the first member's. Layer-wise a state is a
        list of per-entry states, and `merge` puts the entries
        together."""
        per = [s if self.listwise else [s] for s in states]
        merge = merge or (lambda es: es[0])

        def whole(name):
            return merge([self.unravel(e, torch.cat([p[e][name][CHUNK]
                                                     for p in per]))
                          for e in range(self.n_entries)])

        out = {}
        for name, v in per[0][0].items():
            is_chunk = isinstance(v, dict) and set(v) == {CHUNK}
            out[name] = whole(name) if is_chunk else v
        return out


@dataclasses.dataclass(frozen=True)
class ZeROShardedOptimizer:
    """ZeRO-2 over a shard axis of more than one member: wraps an
    Optimizer (init/update/apply, optional pre/shard_update,
    optim/optimizers.py) so its state lives flattened and padded 1/n per
    position while params stay whole.

    `apply(params, opt_state, grads)` takes grads already averaged over
    the axis (the Trainer's `grad_tx`) and

      1. runs the optimizer's `pre` (global-norm clipping) on the full
         gradients,
      2. flattens and pads grads and params and takes the position's
         chunk,
      3. updates the chunk against the position's opt_state chunk,
      4. all-gathers the updated chunks back into whole params.

    The inner optimizer sees a chunk as params ``{CHUNK: (chunk,)}``, so
    its state is the inner state over one chunk. `init` makes it over an
    all-zero chunk: every shard's moments start at zero.

    Layer-wise (`parts`/`merge`, set by `ZeRO3Agent` for a policy with
    blocks) the target splits into entries, the state becomes a list of
    per-entry chunk states, and one all-gather carries every entry."""
    inner: object
    axis: ShardAxis
    parts: object = None   # params -> [entry, ...]
    merge: object = None   # [entry, ...] -> params

    @property
    def n_shards(self) -> int:
        return self.axis.size

    def geometry(self, params) -> ShardGeometry:
        """The layout of `params` (the optimizer's target) over the axis."""
        return ShardGeometry.of(self.axis.name, self.n_shards, params)

    def _chunk_init(self, tree):
        vec, _, _ = flatten_and_pad(tree, self.n_shards)
        return self.inner.init({CHUNK: vec.new_zeros(
            (vec.numel() // self.n_shards,))})

    def init(self, params):
        if self.parts is not None:
            return [self._chunk_init(e) for e in self.parts(params)]
        return self._chunk_init(params)

    def apply(self, params, opt_state, grads):
        pre = self.inner.pre
        bare = (self.inner.shard_update if pre is not None
                else self.inner.update)
        if pre is not None:
            grads = pre(grads)
        listwise = self.parts is not None
        g_es = self.parts(grads) if listwise else [grads]
        p_es = self.parts(params) if listwise else [params]
        states = opt_state if listwise else [opt_state]
        new_chunks, new_states, geoms = [], [], []
        for g_t, p_t, st in zip(g_es, p_es, states):
            gvec, _, _ = flatten_and_pad(g_t, self.n_shards)
            pvec, size, unravel = flatten_and_pad(p_t, self.n_shards)
            p_loc = self.axis.local_shard(pvec)
            upd, st = bare({CHUNK: self.axis.local_shard(gvec)}, st,
                           {CHUNK: p_loc})
            new_chunks.append(p_loc + upd[CHUNK])
            new_states.append(st)
            geoms.append((size, unravel))
        fulls = self.axis.all_gather(new_chunks)
        entries = [unravel(full[:size])
                   for full, (size, unravel) in zip(fulls, geoms)]
        if not listwise:
            return entries[0], new_states[0]
        return _reorder(self.merge(entries), params), new_states


def zero_sharded_optimizer(opt, axis, n_shards: int = None):
    """`opt` wrapped for ZeRO-2 over `axis` (a ShardAxis, or a name with
    `n_shards`); the Trainer installs it on the agent's optimizer for a
    shard-role axis larger than 1."""
    return ZeROShardedOptimizer(opt, _as_axis(axis, n_shards))


class ZeRO3Agent:
    """Full ZeRO-3 over a zero3-role axis, as an Agent wrapper: the inner
    agent's partition (`partition_spec`) is STORED flattened and padded
    1/n per position and all-gathered per use, in `learner_step` and in
    `actor_policy`; the actor ring is stored as chunks too.

    The partition is a list of entries: one entry where the inner agent
    has no block structure (`partition_list` returns None), or one per
    super-block of the trunk plus the remainder (layer-wise). Each entry
    is flattened and padded on its own (`geometry`, a ShardGeometry).

    A position's wrapper-form TrainState:

        params    {"zero3": [(chunk_e,) ...] its chunk of each entry,
                   "rest":  the inner params without the partition}
        ring      [(ring_size, chunk_e) ...]
        opt_state the inner optimizer's (already the ZeRO-2 wrapper, so
                  chunks; per entry when layer-wise)

    `init` returns HOST layout, each chunked leaf with a leading
    (n_shards,) dim (params["zero3"] entries (n_shards, chunk_e), ring
    entries (n_shards, ring_size, chunk_e)); `deal` hands position i its
    share of it and `collect` reassembles a shard group's states into the
    inner agent's tree form, which `host_state` also gives for a host
    layout, so checkpoints and ParamStore templates do not depend on the
    plan. Gathering needs the axis bound (Trainer.fit): an unbound
    wrapper raises on `learner_step` and on `actor_policy` of a
    wrapper-form state; inner-form states pass to the inner agent.
    """

    def __init__(self, inner, axis, n_shards: int = None):
        self.inner = inner
        self.axis = _as_axis(axis, n_shards)
        self.n_shards = self.axis.size
        self.policy = inner.policy
        self.ring_size = inner.ring_size
        self.opt = inner.opt
        self.geometry = None    # resolved by init / shard_state / adopt

    # -- layout plumbing ----------------------------------------------
    def _flatten(self, tree):
        return flatten_and_pad(tree, self.n_shards)

    def _entries(self, part):
        if self.geometry.listwise:
            return list(self.inner.partition_list(part))
        return [part]

    def _merge(self, entries):
        """Inverse of `_entries`, in the partition's key order."""
        if self.geometry.listwise:
            return _reorder(self.inner.merge_partition_list(entries),
                            self.geometry.keys)
        return entries[0]

    def _resolve(self, part):
        """The partition's geometry from a template of it; layer-wise,
        the ZeRO-2 optimizer wrapper moves to per-entry application."""
        self.adopt(ShardGeometry.of(self.axis.name, self.n_shards, part,
                                    self.inner.partition_list(part)))

    def adopt(self, geometry: ShardGeometry) -> None:
        """Take a partition geometry (another position's copy of the same
        wrapper resolved it); layer-wise, the ZeRO-2 optimizer wrapper
        applies per entry."""
        self.geometry = geometry
        if geometry.listwise and isinstance(self.inner.opt,
                                            ZeROShardedOptimizer):
            self.inner.opt = self.opt = dataclasses.replace(
                self.inner.opt, parts=self.inner.partition_list,
                merge=self.inner.merge_partition_list)

    @property
    def partition(self) -> dict:
        """The reference Trainer's `partition` report for a zero3 axis."""
        g = self.geometry
        return dict(g.partition(), sizes=list(g.sizes),
                    chunks=list(g.chunks), entries=g.n_entries)

    def _gather(self, chunks):
        """This position's chunk of each entry -> the partition."""
        fulls = self.axis.all_gather(chunks)
        return self._merge([self.geometry.unravel(e, v)
                            for e, v in enumerate(fulls)])

    def is_wrapper_state(self, state) -> bool:
        """True for wrapper-form TrainStates (chunked params); False for
        the inner tree form (checkpoint restores, fit() output)."""
        return isinstance(state.params, dict) and "zero3" in state.params

    # -- Agent protocol ------------------------------------------------
    def partition_spec(self, state):
        if self.is_wrapper_state(state):
            return state.params["zero3"]
        return self.inner.partition_spec(state)

    def init(self, generator):
        st = self.inner.init(generator)
        part = self.inner.partition_spec(st)
        self._resolve(part)
        if self.geometry.listwise and isinstance(self.inner.opt,
                                                 ZeROShardedOptimizer):
            # the per-entry chunk states (all-zero moments either way)
            st = dataclasses.replace(st, opt_state=self.opt.init(part))
        return self._host_layout(st, part)

    def shard_state(self, st):
        """An inner-form TrainState (a checkpoint restore) in this
        wrapper's HOST layout; its opt_state is kept as it is."""
        part = self.inner.partition_spec(st)
        self._resolve(part)
        return self._host_layout(st, part)

    def _host_layout(self, st, part):
        if sorted(st.ring) != sorted(part):
            raise ValueError(
                "ZeRO-3 requires the actor ring to store the same params "
                "as partition_spec (the behavior params ARE the sharded "
                "partition); got differing keys")
        chunks = self.geometry.chunks
        rows = lambda tree, e: self._flatten(tree)[0].reshape(
            self.n_shards, chunks[e])
        zero3 = [rows(e, i) for i, e in enumerate(self._entries(part))]
        slots = [self._entries({k: r[d] for k, r in st.ring.items()})
                 for d in range(self.ring_size)]
        ring = [torch.stack([rows(slots[d][e], e)
                             for d in range(self.ring_size)], dim=1)
                for e in range(self.geometry.n_entries)]
        params = {"zero3": zero3,
                  "rest": self.inner.replace_partition(st.params, None)}
        return TrainState(params, st.opt_state, st.extra, ring, st.steps)

    def deal(self, host, i: int):
        """Position i's share of a host-layout state: row i of every
        chunked leaf, in storage of its own; the rest shared."""
        return TrainState(
            {"zero3": [c[i].clone() for c in host.params["zero3"]],
             "rest": host.params["rest"]},
            host.opt_state, host.extra, [r[i].clone() for r in host.ring],
            host.steps)

    def collect(self, group):
        """A shard group's wrapper-form states (in shard order) in the
        inner agent's tree form: the param, ring and optimizer-state
        chunks concatenated, trimmed and unraveled; the rest from the
        first member."""
        first = group[0]
        n = self.geometry.n_entries
        host = TrainState(
            {"zero3": [torch.stack([s.params["zero3"][e] for s in group])
                       for e in range(n)],
             "rest": first.params["rest"]},
            None, first.extra,
            [torch.stack([s.ring[e] for s in group]) for e in range(n)],
            first.steps)
        opt = self.geometry.collect_opt_state(
            [s.opt_state for s in group], self._merge)
        return dataclasses.replace(self.host_state(host), opt_state=opt)

    def learner_step(self, state, traj, boot_obs, generator,
                     grad_tx=None, param_tx=None):
        sub = self._gather(state.params["zero3"])
        params = self.inner.replace_partition(state.params["rest"], sub)
        # a one-slot ring: the inner step's ring push is discarded (the
        # chunk ring below is the ring)
        ring1 = {k: v[None] for k, v in sub.items()}
        new, metrics = self.inner.learner_step(
            TrainState(params, state.opt_state, state.extra, ring1,
                       state.steps),
            traj, boot_obs, generator, grad_tx=grad_tx, param_tx=param_tx)
        chunks = [self.axis.local_shard(self._flatten(e)[0]).clone()
                  for e in self._entries(self.inner.partition_spec(new))]
        ring = [torch.cat([c[None], r[:-1]])
                for r, c in zip(state.ring, chunks)]
        params = {"zero3": chunks,
                  "rest": self.inner.replace_partition(new.params, None)}
        return TrainState(params, new.opt_state, new.extra, ring,
                          new.steps), metrics

    def actor_policy(self, state, delay=0):
        if not self.is_wrapper_state(state):
            # the inner form (fit() output, a checkpoint restore)
            return self.inner.actor_policy(state, delay)
        d = min(int(delay), self.ring_size - 1)
        sub = self._gather([r[d] for r in state.ring])
        ring1 = {k: v[None] for k, v in sub.items()}
        # the delay is resolved above; the inner agent may still read
        # steps (DQN's exploration rate)
        return self.inner.actor_policy(
            TrainState(None, None, None, ring1, state.steps), 0)

    def host_state(self, state):
        """A HOST-layout wrapper TrainState (leading (n_shards,) dims on
        the chunked leaves) in the inner agent's tree form, its params
        and ring, with no opt_state (`collect` reassembles a fit's);
        inner-form states pass through unchanged."""
        if not self.is_wrapper_state(state):
            return state
        g = self.geometry
        sub = self._merge([g.unravel(e, c) for e, c
                           in enumerate(state.params["zero3"])])
        params = self.inner.replace_partition(state.params["rest"], sub)
        slots = [self._merge([g.unravel(e, state.ring[e][:, d])
                              for e in range(g.n_entries)])
                 for d in range(self.ring_size)]
        ring = {k: torch.stack([s[k] for s in slots]) for k in g.keys}
        return TrainState(params, None, state.extra, ring, state.steps)
