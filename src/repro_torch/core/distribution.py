"""Distribution Plan API (the port of src/repro/core/distribution.py):
the declarative description of how training is spread over devices
(survey §3 architectures x §6 synchronization, composed hierarchically).

A `DistPlan` is a tuple of named axes (`AxisSpec`), outermost first, each
with its size, its collective (``allreduce`` / ``ps`` / ``gossip``), its
sync discipline (``bsp`` / ``asp`` / ``ssp``, rendered as policy-lag
delays that ADD across axes) and its role: ``data`` (data-parallel
workers), ``shard`` (ZeRO-2), ``zero3`` (ZeRO-3) or ``replay`` (the
sharded replay service: the group holds ONE logical replay buffer, 1/size
of its capacity per member, and replicates its data position's compute),
plus an optional elastic ``actors=`` schedule. The grammar, validation
messages, constructors and derived shapes are the reference's.

Every position of the mesh lives on one device here (core/positions.py):
`build_mesh` places all `n_devices` of them on the Trainer's device, and
the per-axis collectives compile into the Trainer's `grad_tx`/`param_tx`
hooks as pure functions over a leading (mesh...) position layout
(`compile_collectives`). A position's indices (`linear_index`,
`sim_index`) are functions of its mesh coordinates, where the reference
traces `axis_index` sums. Delay schedules draw from an explicit
torch.Generator (core/sync.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.sync import (MECHANISMS, SyncConfig, make_delays,
                                   pipeline_depth as _sync_pipeline_depth)
from repro_torch.core.positions import Mesh
from repro_torch.core.topology import (TOPOLOGIES, exchange_grads,
                                       gossip_mix)
from repro_torch.kernels.common import resolve_device

_SYNC_EXTRA = {"bsp": lambda ax: 0,
               "asp": lambda ax: ax.max_delay,
               "ssp": lambda ax: min(ax.max_delay, ax.staleness_bound)}

ROLES = ("data", "shard", "zero3", "replay")


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """One named mesh axis: its size, how gradients/params are exchanged
    across it (§3), how stale its members may act (§6), and its role —
    `data` (plain data-parallel workers), `shard` (ZeRO-2 learner-
    state sharding: gradients are reduce-scattered over the axis, the
    optimizer update runs on the local 1/size slice of the flattened
    params/opt_state, and params are all-gathered before the next
    rollout), `zero3` (full ZeRO-3: params are additionally STORED
    as 1/size chunks in TrainState and all-gathered per use inside
    learner_step/actor_policy — gather, compute, drop), or `replay`
    (sharded replay service: the group holds ONE logical replay buffer,
    1/size of its capacity per member, while replicating the
    data-position compute)."""
    name: str
    size: int
    collective: str = "allreduce"   # §3: allreduce | ps | gossip
    sync: str = "bsp"               # §6: bsp | asp | ssp
    max_delay: int = 4              # asp worst-case extra staleness
    staleness_bound: int = 1        # ssp bound on extra staleness
    role: str = "data"              # data | shard | zero3 | replay

    def __post_init__(self):
        if not self.name:
            raise ValueError("axis name must be non-empty")
        if self.size < 1:
            raise ValueError(f"axis {self.name!r}: size {self.size} < 1")
        if self.collective not in TOPOLOGIES:
            raise ValueError(f"axis {self.name!r}: collective "
                             f"{self.collective!r} not in {TOPOLOGIES}")
        if self.sync not in MECHANISMS:
            raise ValueError(f"axis {self.name!r}: sync {self.sync!r} "
                             f"not in {MECHANISMS}")
        if self.role not in ROLES:
            raise ValueError(f"axis {self.name!r}: role {self.role!r} "
                             f"not in {ROLES}")
        if self.role in ("shard", "zero3") and self.collective != "allreduce":
            raise ValueError(
                f"axis {self.name!r}: a {self.role}-role axis must use "
                f"the 'allreduce' collective (got {self.collective!r}) — "
                f"its gradient mean fuses into the data-parallel "
                f"reduction so that pmean + local slice IS the "
                f"reduce-scatter (bitwise the replicated plan)")
        if self.role == "replay" and self.collective != "allreduce":
            raise ValueError(
                f"axis {self.name!r}: a replay-role axis must use the "
                f"'allreduce' collective (got {self.collective!r}) — "
                f"the sharded replay service merges per-shard top-k "
                f"candidates and assembles batches with all-gather/psum "
                f"over the axis, which presumes the synchronous "
                f"allreduce domain")
        if self.role == "zero3" and self.sync != "bsp":
            raise ValueError(
                f"axis {self.name!r}: a zero3-role axis must use 'bsp' "
                f"sync (got {self.sync!r}) — the gather-per-use params "
                f"are assembled from one ring slot per shard member, so "
                f"shard-group members must act in lockstep; spend the "
                f"staleness budget on the data axes instead")
        if self.role == "replay" and self.sync != "bsp":
            raise ValueError(
                f"axis {self.name!r}: a replay-role axis must use 'bsp' "
                f"sync (got {self.sync!r}) — replay-group members hold "
                f"slices of ONE logical buffer, so they must act in "
                f"lockstep for its contents to stay coherent; spend the "
                f"staleness budget on the data axes instead")

    @property
    def ring_extra(self) -> int:
        """Actor-ring depth this axis's sync discipline can reach into."""
        return _SYNC_EXTRA[self.sync](self)

    @property
    def pipeline_depth(self) -> int:
        """Trajectory-queue depth this axis's sync discipline admits in
        the Trainer's ``pipeline=`` mode (core/sync.py `pipeline_depth`):
        bsp -> 0 (lockstep), ssp -> staleness_bound, asp -> max_delay.
        Numerically the same staleness budget as `ring_extra` — the
        fused path spends it as sampled policy lag, the pipelined path
        as producer run-ahead."""
        return _sync_pipeline_depth(SyncConfig(
            self.sync, self.size, self.max_delay, self.staleness_bound))


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """Hierarchical distribution plan: mesh axes (outermost first) plus
    an optional elastic actor-shard schedule. Frozen and hashable."""
    axes: Tuple[AxisSpec, ...] = (AxisSpec("workers", 1),)
    actors: Optional[Tuple[int, ...]] = None  # env shards per superstep

    def __post_init__(self):
        if not self.axes:
            raise ValueError("DistPlan needs at least one mesh axis "
                             "(empty axis list)")
        names = [a.name for a in self.axes]
        if len(set(names)) != len(names):
            dups = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate mesh axis name(s) {dups} "
                             f"in {names}")
        shards = [a.name for a in self.axes if a.role in ("shard", "zero3")]
        if len(shards) > 1:
            raise ValueError(f"at most one shard-role axis is supported "
                             f"(got {shards}); compose a bigger shard "
                             f"group as one axis instead")
        replays = [a.name for a in self.axes if a.role == "replay"]
        if len(replays) > 1:
            raise ValueError(f"at most one replay-role axis is supported "
                             f"(got {replays}); compose a bigger replay "
                             f"group as one axis instead")
        if self.actors is not None:
            if not self.actors:
                raise ValueError("actors= schedule must be non-empty")
            bad = [n for n in self.actors if n < 1]
            if bad:
                raise ValueError(f"actors= entries must be >= 1: {bad}")
            object.__setattr__(self, "actors", tuple(self.actors))
        object.__setattr__(self, "axes", tuple(self.axes))

    # ---- constructors -------------------------------------------------
    @classmethod
    def flat(cls, n_workers: int = 1, collective: str = "allreduce",
             sync: str = "bsp", max_delay: int = 4,
             staleness_bound: int = 1, actors=None,
             axis: str = "workers") -> "DistPlan":
        """The legacy single-axis path as a plan: 1-D (workers,) mesh.
        `Trainer(env, TrainerConfig(plan=DistPlan.flat(4)))` is bitwise
        what `n_workers=4, topology="allreduce", sync="bsp"` was."""
        return cls(axes=(AxisSpec(axis, n_workers, collective, sync,
                                  max_delay, staleness_bound),),
                   actors=None if actors is None else tuple(actors))

    @classmethod
    def grid(cls, hosts: int, workers: int,
             inter: str = "allreduce", intra: str = "allreduce",
             inter_sync: str = "bsp", intra_sync: str = "bsp",
             max_delay: int = 4, staleness_bound: int = 1,
             actors=None) -> "DistPlan":
        """First-class 2-D (hosts, workers) plan: `intra` is the
        collective/sync within a host (the inner axis), `inter` across
        hosts (the outer axis) — e.g. intra-host allreduce + inter-host
        gossip."""
        return cls(axes=(AxisSpec("hosts", hosts, inter, inter_sync,
                                  max_delay, staleness_bound),
                         AxisSpec("workers", workers, intra, intra_sync,
                                  max_delay, staleness_bound)),
                   actors=None if actors is None else tuple(actors))

    @classmethod
    def zero(cls, n_workers: int, n_shards: int,
             collective: str = "allreduce", sync: str = "bsp",
             max_delay: int = 4, staleness_bound: int = 1,
             actors=None) -> "DistPlan":
        """Data-parallel workers + a ZeRO-2 shard axis (innermost, so
        the shard group sits on the fastest fabric): gradients reduce-
        scatter over `shard`, the optimizer updates the local 1/n slice,
        params all-gather before the next rollout."""
        return cls(axes=(AxisSpec("workers", n_workers, collective, sync,
                                  max_delay, staleness_bound),
                         AxisSpec("shard", n_shards, "allreduce", "bsp",
                                  max_delay, staleness_bound,
                                  role="shard")),
                   actors=None if actors is None else tuple(actors))

    @classmethod
    def zero3(cls, n_workers: int, n_shards: int,
              collective: str = "allreduce", sync: str = "bsp",
              max_delay: int = 4, staleness_bound: int = 1,
              actors=None) -> "DistPlan":
        """Data-parallel workers + a full ZeRO-3 shard axis (innermost):
        like `zero()` but params are also stored as 1/n chunks and all-
        gathered per use inside learner_step/actor_policy — gather,
        compute, drop — so per-device params+opt_state bytes shrink
        toward 1/n instead of only the opt_state."""
        return cls(axes=(AxisSpec("workers", n_workers, collective, sync,
                                  max_delay, staleness_bound),
                         AxisSpec("shard", n_shards, "allreduce", "bsp",
                                  max_delay, staleness_bound,
                                  role="zero3")),
                   actors=None if actors is None else tuple(actors))

    @classmethod
    def replay(cls, n_workers: int, n_shards: int,
               collective: str = "allreduce", sync: str = "bsp",
               max_delay: int = 4, staleness_bound: int = 1,
               actors=None) -> "DistPlan":
        """Data-parallel workers + a sharded-replay axis (innermost):
        the replay group holds ONE logical replay buffer, each member
        owning a contiguous 1/n slice of its capacity (Gorila's
        distributed replay memory as collectives over the mesh).
        Members replicate the data-axis rollout/learner compute — the
        axis adds replay capacity, not sample throughput — so the fit
        is bitwise the flat `n_workers` plan
        (tests/test_torch_replay_service.py pins it for one worker)."""
        return cls(axes=(AxisSpec("workers", n_workers, collective, sync,
                                  max_delay, staleness_bound),
                         AxisSpec("replay", n_shards, "allreduce", "bsp",
                                  max_delay, staleness_bound,
                                  role="replay")),
                   actors=None if actors is None else tuple(actors))

    @classmethod
    def parse(cls, spec: str, max_delay: int = 4,
              staleness_bound: int = 1, actors=None) -> "DistPlan":
        """Parse the CLI grammar: comma-separated axes, outermost first,
        each ``name=size[:collective[:sync[:role]]]``, e.g.

            hosts=2:allreduce:bsp,workers=2:gossip:asp
            workers=4:allreduce:bsp,shard=2:allreduce:bsp:shard
            workers=4:allreduce:bsp,shard=2:allreduce:bsp:zero3
            workers=2:allreduce:bsp,replay=2:allreduce:bsp:replay

        Role ``shard`` marks the ZeRO-2 learner-state sharding axis,
        ``zero3`` the full ZeRO-3 axis (params stored sharded too,
        gathered per use), ``replay`` the sharded replay-service axis
        (the group holds ONE logical replay buffer, 1/size per member;
        allreduce + bsp only); default ``data``. Empty specs, empty
        segments and duplicate axis names raise errors naming the
        offending input."""
        if not spec or not spec.strip():
            raise ValueError(
                "empty plan: expected comma-separated axes "
                "name=size[:collective[:sync[:role]]], e.g. "
                "'workers=4:allreduce:bsp'")
        axes = []
        for seg in spec.split(","):
            parts = seg.strip().split(":")
            if "=" not in parts[0]:
                raise ValueError(f"bad plan axis {seg!r}: expected "
                                 f"name=size[:collective[:sync[:role]]]")
            name, size = parts[0].split("=", 1)
            try:
                size = int(size)
            except ValueError:
                raise ValueError(f"bad plan axis {seg!r}: size "
                                 f"{size!r} is not an integer") from None
            collective = parts[1] if len(parts) > 1 else "allreduce"
            sync = parts[2] if len(parts) > 2 else "bsp"
            role = parts[3] if len(parts) > 3 else "data"
            if len(parts) > 4:
                raise ValueError(f"bad plan axis {seg!r}: too many ':' "
                                 f"(grammar is name=size[:collective"
                                 f"[:sync[:role]]])")
            axes.append(AxisSpec(name.strip(), size, collective,
                                 sync, max_delay, staleness_bound, role))
        return cls(axes=tuple(axes),
                   actors=None if actors is None else tuple(actors))

    # ---- derived shape ------------------------------------------------
    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        return tuple(a.size for a in self.axes)

    @property
    def n_devices(self) -> int:
        n = 1
        for a in self.axes:
            n *= a.size
        return n

    @property
    def ring_extra(self) -> int:
        """Worst-case total extra staleness: per-axis delays add."""
        return sum(a.ring_extra for a in self.axes)

    @property
    def pipeline_depth(self) -> int:
        """Trajectory-queue depth of the plan in the Trainer's
        ``pipeline=`` mode: per-axis staleness budgets add, exactly as
        the per-axis delay schedules add in the fused rendering. A pure
        bsp plan has depth 0 — the pipelined superstep degenerates to
        lockstep."""
        return sum(a.pipeline_depth for a in self.axes)

    @property
    def shard_axis(self) -> Optional[AxisSpec]:
        """The (single, validated) ZeRO shard-role axis — role `shard`
        (ZeRO-2) or `zero3` — or None."""
        for a in self.axes:
            if a.role in ("shard", "zero3"):
                return a
        return None

    @property
    def data_axes(self) -> Tuple[AxisSpec, ...]:
        return tuple(a for a in self.axes if a.role == "data")

    @property
    def shard_size(self) -> int:
        """Learner-state shard count (1 when no shard axis)."""
        ax = self.shard_axis
        return 1 if ax is None else ax.size

    @property
    def replay_axis(self) -> Optional[AxisSpec]:
        """The (single, validated) replay-role axis, or None."""
        for a in self.axes:
            if a.role == "replay":
                return a
        return None

    @property
    def replay_size(self) -> int:
        """Replay shard count (1 when no replay axis)."""
        ax = self.replay_axis
        return 1 if ax is None else ax.size

    @property
    def sim_shape(self) -> Tuple[int, ...]:
        """Mesh shape with the ACTIVE replay axis (size > 1) collapsed
        to 1 — the env grid: replay-group members replicate the rollout
        of their data position (the axis adds replay capacity, not
        sample throughput), so envs shard over the non-replay axes
        only. A size-1 replay axis stays a plain data axis (the no-op
        guarantee holds by construction)."""
        return tuple(1 if (a.role == "replay" and a.size > 1) else a.size
                     for a in self.axes)

    @property
    def sim_devices(self) -> int:
        """Device count of the env grid (`sim_shape`); equals
        `n_devices` on plans without an active replay axis."""
        n = 1
        for s in self.sim_shape:
            n *= s
        return n

    def describe(self) -> str:
        s = ",".join(f"{a.name}={a.size}:{a.collective}:{a.sync}"
                     + (f":{a.role}" if a.role != "data" else "")
                     for a in self.axes)
        if self.actors is not None:
            s += ";actors=" + ",".join(map(str, self.actors))
        return s

    # ---- positions on one device ---------------------------------------
    def validate_devices(self, device="cuda") -> torch.device:
        """Every one of the plan's `n_devices` positions lives on
        `device`: one card holds them all, so any plan fits. Raises
        RuntimeError where CUDA is asked for and this process has no
        card, instead of running on the CPU."""
        return resolve_device(device)

    def build_mesh(self, device="cuda") -> Mesh:
        """The plan's named axes with every position on `device`.
        Positions are taken row-major: the one at mesh coordinates (i0,
        i1, ...) is flat position ``linear_index(coords)``, the order the
        flat plan uses, so nesting never permutes which envs and streams
        a position owns."""
        return Mesh(self.axis_names, self.mesh_shape,
                    self.validate_devices(device))

    def linear_index(self, coords) -> int:
        """The flat position index of mesh coordinates `coords`
        (outermost first), as the flat plan's worker index."""
        idx = coords[0]
        for a, i in zip(self.axes[1:], coords[1:]):
            idx = idx * a.size + i
        return idx

    def sim_index(self, coords) -> int:
        """The position's index over the env grid (`sim_shape`), its
        stream id: like `linear_index`, but an ACTIVE replay axis
        contributes nothing, so every member of a replay group draws its
        data position's streams. On plans without an active replay axis
        this is `linear_index` term for term."""
        idx = 0
        for a, i in zip(self.axes, coords):
            if not (a.role == "replay" and a.size > 1):
                idx = idx * a.size + i
        return idx

    def sim_coords(self):
        """The mesh coordinates of the env grid's positions, in
        `sim_index` order, each with the replay coordinate at 0."""
        coords = [()]
        for s in self.sim_shape:
            coords = [c + (i,) for c in coords for i in range(s)]
        return coords

    def compile_collectives(self):
        """(grad_tx, param_tx): the per-axis collectives, innermost axis
        first, as functions of a tree whose leaves carry one leading dim
        per mesh axis (an active replay axis may be collapsed to 1: it
        is never reduced over). Consecutive allreduce axes fuse into one
        mean over their dims (bitwise the flat all-reduce: the same
        members summed in the same order); ps gathers and means each of
        its axes on its own; gossip skips the gradient exchange and
        ring-mixes params on its axis instead. grad_tx is None when no
        axis exchanges gradients, param_tx when no axis gossips."""
        steps = []  # innermost -> outermost: (kind, dims outermost first)
        for k in reversed(range(len(self.axes))):
            ax = self.axes[k]
            if ax.role == "replay" and ax.size > 1:
                # replay-group members compute identical gradients (same
                # envs, streams and batch; only replay storage differs)
                continue
            if ax.collective == "allreduce":
                if steps and steps[-1][0] == "allreduce":
                    steps[-1] = ("allreduce", (k,) + steps[-1][1])
                else:
                    steps.append(("allreduce", (k,)))
            elif ax.collective == "ps":
                steps.append(("ps", (k,)))
        gossip_dims = tuple(k for k in reversed(range(len(self.axes)))
                            if self.axes[k].collective == "gossip")

        def grad_tx(grads):
            for kind, dims in steps:
                grads = exchange_grads(grads, kind, dims)
            return grads

        def param_tx(params):
            for k in gossip_dims:
                params = gossip_mix(params, k)
            return params

        return ((grad_tx if steps else None),
                (param_tx if gossip_dims else None))

    def make_delay_schedule(self, n_steps: int, generator):
        """(n_steps,) + mesh_shape int32 delays: per-axis §6 schedules
        broadcast over the other axes and summed. A single-axis plan
        draws exactly what `sync.make_delays` draws from `generator` (the
        legacy schedule); multi-axis plans draw axis after axis,
        outermost first."""
        total = torch.zeros((n_steps,) + self.mesh_shape, dtype=torch.int32,
                            device=generator.device)
        for i, ax in enumerate(self.axes):
            d = make_delays(SyncConfig(ax.sync, ax.size, ax.max_delay,
                                       ax.staleness_bound),
                            n_steps, generator)       # (n_steps, size)
            shape = [n_steps] + [1] * len(self.axes)
            shape[1 + i] = ax.size
            total = total + d.reshape(shape)
        return total

    def actor_schedule(self, superstep_idx: int, default: int) -> int:
        """Total env-shard count for superstep window `superstep_idx`
        (iteration // cfg.superstep — NOT the dispatch count, so fused
        and unfused fits reshard at the same iteration boundaries; the
        schedule cycles); `default` when the plan is not elastic."""
        if self.actors is None:
            return default
        return self.actors[superstep_idx % len(self.actors)]
