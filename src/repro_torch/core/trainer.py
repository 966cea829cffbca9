"""The Trainer on one device (the port of src/repro/core/trainer.py).

Each iteration is rollout -> learner_step -> lag-ring push over a batch
of envs. `fit(fused=True)` runs `superstep` iterations per dispatch with
the metrics left on the device and read back once per superstep (one
`.cpu()`); `fit(fused=False)` runs one iteration per dispatch. The loop
is eager PyTorch.

Randomness is a pure function of (seed, iteration): every iteration
reseeds the device generator from a hash of the two before its rollout
and again before its learner step, as the reference's `_iter_key` folds
the iteration into its base key. So fused and unfused fits are bitwise
equal by construction.

A `DistPlan` (core/distribution.py) with W data positions (W =
`plan.sim_devices`, the product of the env grid's axes) runs them all on
the one device, one thread each (core/positions.py), as the reference's
shard_map runs one program per device:

  * the Trainer resets all `n_envs` envs from one stream and gives
    position i the contiguous slice [i·per, (i+1)·per), row-major over
    the mesh, as the reference's `_shard_sim`;
  * position i draws its streams from `stream_seed(seed, it, stream,
    sim_index)`, the reference's `fold_in(key, plan.sim_index())`, and
    acts with its own delay `schedule[it][coords_i]`;
  * the positions meet only in the learner's `grad_tx` / `param_tx`
    hooks, the plan's collectives (`compile_collectives`), each reduced
    in rank order;
  * the metrics are averaged over the positions each iteration, in rank
    order, and `fit` returns position 0's state.

A plan with one data position runs without threads, hooks or a group,
exactly as a planless fit does: any sync discipline (its delay schedule,
drawn once per fit, feeds `actor_policy(state, delay)` each iteration),
and a replay-role axis larger than 1. A replay axis turns the agent's
prioritized buffer into the sharded replay service
(core/replay_service.py), its R members held as a leading dimension; they
replicate their data position's rollout and learner, so the fit is
bitwise the flat fit. With W positions, each holds its own replay group.

An elastic `actors=` schedule reshards the envs between supersteps, as
the reference's `_reshard_envs`.

One process a position (`Trainer(..., positions=ProcessPositions)`, the
reference's one program per device): the process runs its own rank's
iterations only. It computes the env reset, the slices, stream ids,
delays and reshards of every position from the seed as above and keeps
its own; the collectives and the per-iteration metrics go through the
process group in rank order, so the fit is bitwise the threaded fit;
`fit` gathers every position's final state and returns position 0's
(shard group 0's, reassembled) on every rank.

Sharded learner states (survey §5's memory ceiling, ZeRO): a shard-role
axis larger than 1 is a data axis whose members also split the learner
state, each position's agent copy bound to its shard coordinate and to
the all-gather over its shard group (`topology.ShardAxis`, a
`PositionGroup` collective) for the length of a fit. Role `shard`
(ZeRO-2) wraps the optimizer (`zero_sharded_optimizer`: its state 1/n
per position, params whole); role `zero3` also wraps the agent
(`ZeRO3Agent`: params and actor ring stored as chunks, gathered per use
in the learner step and in every rollout's `actor_policy`). Position i
on the shard axis holds chunk i. `fit` reassembles shard group 0's
chunks, so it returns the plan-independent tree form, and a sharded fit
is bitwise the flat fit of the same positions. A size-1 shard axis stays
unwrapped, a data axis by construction.

Pipelined mode (`TrainerConfig.pipeline=True`, the survey §2
actor/learner split): each position's iteration is split at the
trajectory seam into a rollout producer and a learner consumer joined by
its own trajectory queue (core/pipeline.py). The depth is what the
plan's sync disciplines admit (`DistPlan.pipeline_depth`: bsp 0, ssp
staleness_bound, asp max_delay) and the producer acts at the constant
`policy_lag`. At depth 0 the produced item goes straight to the
consumer: the fused fit, bitwise. At depth d >= 1 a tick pops the item
produced d ticks before, produces iteration it + d from the carry-in
state, pushes it, then consumes the popped one; a prologue fills the
queue with iterations 0 .. d - 1 and the queue persists across
supersteps, so chunking changes nothing. On this eager loop the split
gives the reference's structural staleness, not overlap: the producer
and the consumer issue from one thread, in turn.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.core import agent as agent_api
from repro_torch.core.distribution import DistPlan
from repro_torch.core.networks import stream_seed
from repro_torch.core.pipeline import queue_init, queue_pop, queue_push
from repro_torch.core.positions import PositionGroup, tree_leaves, tree_map
from repro_torch.core.replay import PrioritizedReplay
from repro_torch.core.replay_service import ShardedPrioritizedReplay
from repro_torch.core.rollout import rollout
from repro_torch.core.topology import (ShardAxis, ZeRO3Agent, member_sum,
                                       zero_sharded_optimizer)
from repro_torch.tracing import record, span, spanned

# the per-iteration streams, and the set-up streams (iteration -1); an
# elastic reshard's fresh envs draw from (-1, _RESHARD, superstep window)
_ROLL, _LEARN, _INIT, _ENV, _DELAY, _RESHARD = 0, 1, 2, 3, 4, 5


def state_bytes(states) -> int:
    """The bytes of every storage that the TrainStates hold, each storage
    counted once (positions may share tensors)."""
    seen = {}
    for st in states:
        for part in (st.params, st.opt_state, st.extra, st.ring, st.steps):
            for t in tree_leaves(part):
                if isinstance(t, torch.Tensor):
                    store = t.untyped_storage()
                    seen[store.data_ptr()] = store.nbytes()
    return sum(seen.values())


def state_to(state, device):
    """`state` (a TrainState) with every tensor on `device`."""
    def move(t):
        return t.to(device) if isinstance(t, torch.Tensor) else t

    return agent_api.TrainState(*(tree_map(move, part) for part in (
        state.params, state.opt_state, state.extra, state.ring,
        state.steps)))


@dataclasses.dataclass
class TrainerConfig:
    algo: str = "impala"
    iters: int = 60
    superstep: int = 10        # K iterations per dispatch (fused mode)
    n_envs: int = 32           # total envs (split across data positions)
    unroll: int = 32           # rollout length T per iteration
    plan: Optional[DistPlan] = None  # distribution plan; None = 1 worker
    policy_lag: int = 0        # deterministic actor-param lag
    seed: int = 0
    log_every: int = 10
    donate: bool = True        # the reference's buffer donation; eager
    #                            PyTorch has none, so it changes nothing
    pipeline: bool = False     # decoupled actor-learner trajectory queue
    algo_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def resolved_plan(self) -> DistPlan:
        return self.plan if self.plan is not None else DistPlan.flat()

    @property
    def ring_size(self) -> int:
        """Actor-param history depth the plan's sync hierarchy can reach
        into (per-axis staleness adds), plus the newest slot."""
        return self.policy_lag + self.resolved_plan().ring_extra + 1


class Trainer:
    """Drives any registered Agent under a DistPlan on one device; see
    module doc."""

    def __init__(self, env, cfg: TrainerConfig, device="cuda",
                 positions=None):
        plan = cfg.resolved_plan()
        if positions is not None and positions.n != plan.sim_devices:
            raise ValueError(
                f"a process group of {positions.n} ranks for the plan's "
                f"{plan.sim_devices} data positions (mesh "
                f"{plan.mesh_shape}): one process a position")
        # envs shard over the env grid (an active replay axis replicates
        # its data position's envs), so divisibility is against it
        if cfg.n_envs % plan.sim_devices:
            raise ValueError(f"n_envs={cfg.n_envs} must divide evenly "
                             f"across the plan's {plan.sim_devices} "
                             f"simulation devices (mesh "
                             f"{plan.mesh_shape}, env grid "
                             f"{plan.sim_shape})")
        if plan.actors is not None:
            bad = [n for n in plan.actors if n % plan.sim_devices]
            if bad:
                raise ValueError(
                    f"actors= schedule entries {bad} must divide evenly "
                    f"across the plan's {plan.sim_devices} simulation "
                    f"devices")
        if cfg.pipeline and plan.actors is not None \
                and len(set(plan.actors)) > 1:
            raise ValueError(
                f"pipeline=True cannot combine with a varying elastic "
                f"actors= schedule {plan.actors}: the trajectory queue's "
                f"buffer shape is fixed per compile, so in-flight "
                f"trajectories cannot be resharded — use a constant "
                f"schedule or fused mode")
        # every position lives on this one device
        self.device = plan.validate_devices(device)
        self.env = env
        self.cfg = cfg
        self.plan = plan
        self.agent = agent_api.make(cfg.algo, env=env,
                                    ring_size=cfg.ring_size,
                                    total_iters=cfg.iters,
                                    device=self.device, **cfg.algo_kwargs)
        shard = plan.shard_axis
        self._sharded = (shard is not None and shard.size > 1
                         and plan.n_devices > 1)
        self._zero3 = self._sharded and shard.role == "zero3"
        if self._zero3 and cfg.pipeline:
            raise ValueError(
                f"pipeline=True cannot combine with the zero3-role axis "
                f"{shard.name!r}: the trajectory queue's item template "
                f"is shape-traced outside the mesh program, where the "
                f"gather-per-use actor params have no axis environment "
                f"— use role 'shard' (ZeRO-2) or fused mode")
        if self._sharded and not hasattr(self.agent, "opt"):
            raise ValueError(
                f"algorithm {cfg.algo!r} exposes no `.opt` optimizer — "
                f"required to execute the shard-role axis "
                f"{shard.name!r} (ZeRO learner-state sharding)")
        self._replay_service = None
        self.partition_replay = None
        rax = plan.replay_axis
        if rax is not None and rax.size > 1:
            # on the raw agent, before the ZeRO-3 wrap: the wrapper
            # forwards learner_step to it
            self._swap_in_replay_service(rax)
        self.partition = None    # the shard axis's report, set by fit
        self._geometry = None    # ZeRO-2's layout (zero3: the wrapper's)
        if self._sharded:
            axis = ShardAxis(shard.name, shard.size)
            self.agent.opt = zero_sharded_optimizer(self.agent.opt, axis)
            if self._zero3:
                self.agent = ZeRO3Agent(self.agent, axis)
        self.pipeline_depth = plan.pipeline_depth if cfg.pipeline else 0
        # the data positions: the env grid's, row-major (replay axis 0)
        self.n_positions = plan.sim_devices
        # one process a position: this process runs rank `_procs.rank`
        self._procs = positions
        self._ranks = ([positions.rank] if positions is not None
                       else list(range(self.n_positions)))
        self._coords = plan.sim_coords()
        if self._sharded:
            # rank r's shard group: the ranks that differ from it only on
            # the shard axis, in shard order (row-major: ascending)
            self._shard_k = plan.axis_names.index(shard.name)
            key = lambda c: c[:self._shard_k] + c[self._shard_k + 1:]
            groups = {}
            for r, c in enumerate(self._coords):
                groups.setdefault(key(c), []).append(r)
            self._shard_members = [groups[key(c)] for c in self._coords]
        self._stream_ids = [plan.sim_index(c) for c in self._coords]
        self._collectives = (plan.compile_collectives()
                             if self.n_positions > 1 else None)
        # an agent per position: a policy runs its params through
        # `functional_call`, which swaps them into the shared module for
        # the call, so two threads must not share one (the copies hold
        # meta-device templates and config, no weights)
        self._agents = [self.agent] + [copy.deepcopy(self.agent)
                                       for _ in range(1, self.n_positions)]
        self._gens = [torch.Generator(device=self.device)
                      for _ in range(self.n_positions)]
        self._hooks = [(None, None)] * self.n_positions
        self.actor_shards = []   # env count per superstep dispatch
        self.superstep_s = []    # host seconds per superstep dispatch,
        #                          each ending in its metrics' read back
        self.state_bytes = None  # every position's TrainState bytes, at
        #                          the end of the last fit

    @property
    def pipeline_capacity(self) -> Optional[int]:
        """The trajectory queue's capacity (None when fused): steady state
        holds `pipeline_depth` items; depth 0 has one slot."""
        return max(self.pipeline_depth, 1) if self.cfg.pipeline else None

    def _swap_in_replay_service(self, rax):
        """The agent's prioritized buffer becomes ONE logical buffer over
        the replay axis `rax`, 1/size capacity per member (a size-1 axis
        stays unwrapped: it is a data axis by construction)."""
        cfg = self.cfg
        if cfg.pipeline:
            raise ValueError(
                f"pipeline=True cannot combine with the replay-role "
                f"axis {rax.name!r}: the decoupled superstep reorders "
                f"the add_batch/sample interleaving against the "
                f"sharded buffer and that combination has no validated "
                f"parity — use the fused superstep (pipeline=False) or "
                f"drop the replay axis")
        flat_replay = getattr(self.agent, "replay", None)
        if not isinstance(flat_replay, PrioritizedReplay):
            raise ValueError(
                f"replay axis {rax.name!r}: algorithm {cfg.algo!r} "
                f"does not carry a PrioritizedReplay on its learner "
                f"hot path (agent.replay) — the sharded replay "
                f"service backs that seam only (DQN; ERL's "
                f"evolutionary buffer rides its own loop)")
        if not flat_replay.fused:
            raise ValueError(
                f"replay axis {rax.name!r}: the sharded replay "
                f"service decomposes the fused Gumbel-top-k draw "
                f"per shard; the legacy categorical path "
                f"(fused_sampling=False) has no such decomposition "
                f"— drop fused_sampling=False or the replay axis")
        # capacity % axis size raises here, naming the axis
        self._replay_service = ShardedPrioritizedReplay(
            flat_replay.capacity, rax.name, rax.size,
            alpha=flat_replay.alpha, beta=flat_replay.beta,
            eps=flat_replay.eps, use_kernel=flat_replay.use_kernel)
        self.agent.replay = self._replay_service
        self.partition_replay = {
            "axis": rax.name, "n_shards": rax.size,
            "capacity": flat_replay.capacity,
            "chunk": self._replay_service.chunk}

    def _generator(self, it: int, stream: int, rank: int = 0):
        """Position `rank`'s device generator, reseeded for (iteration,
        stream); with more than one position its stream id joins the
        hash (the reference's fold_in of `sim_index`)."""
        ids = ((it, stream) if self.n_positions == 1
               else (it, stream, self._stream_ids[rank]))
        return self._gens[rank].manual_seed(stream_seed(self.cfg.seed,
                                                        *ids))

    # ---- episode accounting (carried across iterations) --------------
    @staticmethod
    @spanned("repro_torch.rl.episodes")
    def _episode_stats(ep_run, ep_last, traj):
        """Exact per-episode returns from a (T, B) reward/done block.

        `ep_run` carries each env's within-episode reward sum across
        iteration boundaries, so `episode_return` is the mean return of
        episodes that *completed* this iteration. With zero completions
        the last known value (NaN before the first episode ever finishes)
        is reported instead."""
        run = ep_run
        tot = torch.zeros((), device=run.device)
        cnt = torch.zeros((), dtype=torch.int32, device=run.device)
        for r, d in zip(traj["reward"], traj["done"]):
            run = run + r
            tot = tot + torch.where(d, run, 0.0).sum()
            cnt = cnt + d.sum(dtype=torch.int32)
            run = torch.where(d, 0.0, run)
        ep_ret = torch.where(cnt > 0, tot / torch.clamp(cnt, min=1), ep_last)
        return run, ep_ret

    # ---- producer/consumer halves ------------------------------------
    @spanned("repro_torch.rl.rollout")
    def _produce(self, state, env_state, it, delay=None, rank=0):
        """One trajectory for iteration `it` plus its bootstrap
        observation, acting with the params `delay` updates old."""
        delay = self.cfg.policy_lag if delay is None else delay
        gen = self._generator(it, _ROLL, rank)
        agent = self._agents[rank]
        actor = agent.actor_policy(state, delay)
        traj, env_state = rollout(agent.policy, actor, self.env, gen,
                                  env_state, self.cfg.unroll)
        return {"traj": traj, "boot": self.env.obs(env_state)}, env_state

    @spanned("repro_torch.rl.learner")
    def _consume(self, state, ep_run, ep_last, item, it, rank=0):
        """One learner_step on an item plus the episode accounting; with
        more than one position the plan's collectives ride in the
        learner's hooks."""
        gen = self._generator(it, _LEARN, rank)
        grad_tx, param_tx = self._hooks[rank]
        agent = self._agents[rank]
        if grad_tx is None and param_tx is None:
            state, metrics = agent.learner_step(state, item["traj"],
                                                item["boot"], gen)
        else:
            state, metrics = agent.learner_step(
                state, item["traj"], item["boot"], gen, grad_tx=grad_tx,
                param_tx=param_tx)
        ep_run, ep_ret = self._episode_stats(ep_run, ep_last, item["traj"])
        return state, ep_run, ep_ret, dict(metrics, episode_return=ep_ret)

    def _iteration(self, state, sim, it, delay=None, rank=0):
        item, env_state = self._produce(state, sim["env"], it, delay, rank)
        state, ep_run, ep_ret, metrics = self._consume(
            state, sim["ep_run"], sim["ep_last"], item, it, rank)
        return state, {"env": env_state, "ep_run": ep_run,
                       "ep_last": ep_ret}, metrics

    def _pipe_tick(self, state, sim, queue, it, rank=0):
        """One pipelined tick consuming iteration `it` (depth >= 1): pop
        the item produced `depth` ticks ago, produce iteration it + depth
        from the carry-in state and push it, then consume the popped
        item. Depth 0 is `_iteration`: no queue round trip."""
        d = self.pipeline_depth
        queue, item, ok = queue_pop(queue)
        if not ok:
            raise RuntimeError(f"position {rank}: the trajectory queue "
                               f"was empty at iteration {it}")
        produced, env_state = self._produce(state, sim["env"], it + d,
                                            self.cfg.policy_lag, rank)
        queue, ok = queue_push(queue, produced)
        if not ok:
            raise RuntimeError(f"position {rank}: the trajectory queue "
                               f"was full at iteration {it}")
        state, ep_run, ep_ret, metrics = self._consume(
            state, sim["ep_run"], sim["ep_last"], item, it, rank)
        return state, {"env": env_state, "ep_run": ep_run,
                       "ep_last": ep_ret}, queue, metrics

    def _fill_queue(self, state, sim, rank):
        """The pipeline's prologue at one position: a queue holding
        iterations 0 .. depth - 1, produced from the initial state (the
        first item is also the queue's template)."""
        env_state, queue = sim["env"], None
        for it in range(self.pipeline_depth):
            item, env_state = self._produce(state, env_state, it,
                                            self.cfg.policy_lag, rank)
            if queue is None:
                queue = queue_init(item, self.pipeline_capacity)
            queue, _ = queue_push(queue, item)
        return dict(sim, env=env_state), queue

    def _init_all(self):
        """Every position's TrainState, sim carry and delay list."""
        cfg = self.cfg
        W = self.n_positions
        init_gen = torch.Generator().manual_seed(
            stream_seed(cfg.seed, -1, _INIT))
        state = self.agent.init(init_gen)
        if self._sharded:
            self.partition = self._lay_out(state)
        if self._replay_service is not None:
            # the flat buffer the agent inits, sharded over the group
            service = self._replay_service
            state = self._swap_replay(
                state, service.shard_state(state.extra["replay"]))
        # the positions share the initial tensors: every update is
        # functional, so each position's first step makes its own
        states = [state] * W
        if self._zero3:
            # host layout dealt out: position i on the shard axis holds
            # chunk i
            k = self._shard_k
            states = [self.agent.deal(state, c[k]) for c in self._coords]
        # all n_envs from one stream, position r the r-th contiguous slice
        env_state = self.env.reset(self._gens[0].manual_seed(
            stream_seed(cfg.seed, -1, _ENV)), cfg.n_envs)
        per = cfg.n_envs // W
        # ep_last starts NaN: no episode has finished yet
        sims = [{"env": env_state if W == 1 else tree_map(
                     lambda a, r=r: a[r * per:(r + 1) * per], env_state),
                 "ep_run": torch.zeros((per,), device=self.device),
                 "ep_last": torch.full((), float("nan"), device=self.device)}
                for r in range(W)]
        # the plan's per-axis delays add; position r acts with its own,
        # at its mesh coordinates (a replay group's members share their
        # data position's). Host lists: the ring read takes a Python int
        delay_gen = torch.Generator().manual_seed(
            stream_seed(cfg.seed, -1, _DELAY))
        schedule = self.plan.make_delay_schedule(cfg.iters, delay_gen)
        schedule = schedule.reshape(cfg.iters, -1)
        delays = [(schedule[:, self.plan.linear_index(c)]
                   + cfg.policy_lag).tolist() for c in self._coords]
        return states, sims, delays

    @staticmethod
    def _swap_replay(state, rstate):
        return agent_api.TrainState(state.params, state.opt_state,
                                    dict(state.extra, replay=rstate),
                                    state.ring, state.steps)

    # ---- sharded learner states (shard / zero3 axes) -------------------
    def _lay_out(self, state):
        """The shard axis's geometry and its `partition` report; under
        zero3 every position's wrapper copy takes rank 0's."""
        if self._zero3:
            for other in self._agents[1:]:
                other.adopt(self.agent.geometry)
            return self.agent.partition
        self._geometry = self.agent.opt.geometry(
            self.agent.partition_spec(state))
        return self._geometry.partition()

    def _unshard(self, states):
        """Shard group 0's states (rank 0 and its group) reassembled into
        the plan-independent tree form: the optimizer-state chunks (under
        zero3 the param and ring chunks too) concatenated in shard order
        and unraveled; the rest from rank 0."""
        group = [states[r] for r in self._shard_members[0]]
        if self._zero3:
            return self.agent.collect(group)
        opt = self._geometry.collect_opt_state([s.opt_state for s in group])
        return dataclasses.replace(states[0], opt_state=opt)

    def _gather_states(self, own):
        """Every position's final TrainState from its process, in rank
        order and on this device (through the host, bitwise), and the
        bytes they hold together (each process's `state_bytes`)."""
        got = self._procs.gather_objects((state_to(own, "cpu"),
                                          state_bytes([own])))
        return ([own if r == self._procs.rank else state_to(st, self.device)
                 for r, (st, _) in enumerate(got)],
                sum(n for _, n in got))

    # ---- elastic actor shards (plan.actors) ---------------------------
    def _reshard_envs(self, sims, n_total, s_idx):
        """Grow or shrink every position's env count to n_total / W
        between supersteps. Shrinking drops each position's trailing envs
        (their in-flight episode sums with them); growing resets
        (per_new - per_cur) · W fresh envs from the window's own stream
        and gives position r the r-th contiguous slice of them, after its
        own. The agents never see it: they only consume `traj`."""
        W = len(sims)
        per_new = n_total // W
        per_cur = sims[0]["ep_run"].shape[0]
        if per_new == per_cur:
            return sims
        if per_new < per_cur:
            cut = lambda a: a[:per_new]
            return [{"env": tree_map(cut, s["env"]),
                     "ep_run": cut(s["ep_run"]), "ep_last": s["ep_last"]}
                    for s in sims]
        grow = per_new - per_cur
        gen = torch.Generator(device=self.device).manual_seed(
            stream_seed(self.cfg.seed, -1, _RESHARD, s_idx))
        fresh = self.env.reset(gen, grow * W)
        out = []
        for r, s in enumerate(sims):
            part = lambda a, r=r: a[r * grow:(r + 1) * grow]
            out.append({
                "env": tree_map(lambda a, b: torch.cat([a, part(b)]),
                                s["env"], fresh),
                "ep_run": torch.cat([s["ep_run"], torch.zeros(
                    (grow,), device=self.device)]),
                "ep_last": s["ep_last"]})
        return out

    # ---- the loop ----------------------------------------------------
    def _run(self, states, sims, queues, delays, start, k, group):
        """Iterations start .. start + k - 1 at every position, updating
        `states`, `sims` and `queues` in place; returns each position's
        list of per-iteration metrics."""
        def work(r):
            state, sim, queue, per = states[r], sims[r], queues[r], []
            for it in range(start, start + k):
                if queue is None:
                    state, sim, metrics = self._iteration(
                        state, sim, it, delays[r][it], r)
                else:
                    state, sim, queue, metrics = self._pipe_tick(
                        state, sim, queue, it, r)
                per.append(metrics)
            states[r], sims[r], queues[r] = state, sim, queue
            return per

        if group is None or self._procs is not None:
            return [work(r) for r in self._ranks]
        grad = torch.is_grad_enabled()

        def in_thread(r):   # the caller's grad mode and current device
            with torch.set_grad_enabled(grad), (
                    torch.cuda.device(self.device)
                    if self.device.type == "cuda"
                    else contextlib.nullcontext()):
                return work(r)

        return group.run(in_thread)

    def fit(self, fused: bool = True, trace_out=None):
        """Train for cfg.iters iterations. Returns (TrainState, history);
        with more than one data position, position 0's state. With
        `trace_out` (a path), the last superstep runs under the profiler
        and its Chrome trace and counters are written there
        (`tracing.record`)."""
        cfg = self.cfg
        W = self.n_positions
        states, sims, delays = self._init_all()
        queues = [None] * W
        if cfg.pipeline:
            # the producer acts at the constant policy_lag: the queue's
            # depth is the staleness, not a sampled delay
            delays = [[cfg.policy_lag] * cfg.iters for _ in range(W)]
            if self.pipeline_depth:
                # the queue holds envs of the first window's size (a
                # varying schedule is refused); then it persists across
                # supersteps, no drain
                sims = self._reshard_envs(
                    sims, self.plan.actor_schedule(0, cfg.n_envs), 0)
                for r in self._ranks:
                    sims[r], queues[r] = self._fill_queue(states[r],
                                                          sims[r], r)
        group = None
        if W > 1:
            group = self._procs or PositionGroup(W)
            grad_fn, param_fn = self._collectives
            lead = self.plan.sim_shape
            for r in self._ranks:
                self._hooks[r] = (grad_fn and group.hook(r, grad_fn, lead),
                                  param_fn and group.hook(r, param_fn, lead))
                if self._sharded:
                    self._agents[r].opt.axis.bind(
                        self._coords[r][self._shard_k],
                        group.shard_gather(r, self._shard_members))
        K = cfg.superstep if fused else 1
        history = []
        start = 0
        self.actor_shards = []
        self.superstep_s = []
        try:
            while start < cfg.iters:
                k = min(K, cfg.iters - start)
                traced = trace_out is not None and start + k == cfg.iters
                with (record(trace_out) if traced
                      else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    # the schedule's window is the cfg.superstep-iteration
                    # window, not the dispatch: fused and unfused fits
                    # reshard at the same iterations
                    s_idx = start // cfg.superstep
                    n_envs = self.plan.actor_schedule(s_idx, cfg.n_envs)
                    sims = self._reshard_envs(sims, n_envs, s_idx)
                    self.actor_shards.append(n_envs)
                    per = self._run(states, sims, queues, delays, start, k,
                                    group)
                    names = sorted(per[0][0])
                    stacked = [torch.stack([torch.stack([m[n] for m in p])
                                            for n in names]) for p in per]
                    if W > 1 and self._procs is not None:
                        stacked = self._procs.all_gather(stacked[0])
                    # positions averaged each iteration, in rank order
                    values = (stacked[0] if W == 1
                              else member_sum(torch.stack(stacked)) / W)
                    with span("repro_torch.rl.sync"):
                        values = values.cpu()          # ONE host sync
                    self.superstep_s.append(time.perf_counter() - t0)
                for j in range(k):
                    it = start + j
                    if it % cfg.log_every == 0 or it == cfg.iters - 1:
                        history.append({"iter": it, **{
                            n: round(float(values[i, j]), 4)
                            for i, n in enumerate(names)}})
                start += k
        finally:
            if group is not None:
                if self._procs is None:
                    group.close()
                self._hooks = [(None, None)] * W
                if self._sharded:
                    for a in self._agents:
                        a.opt.axis.unbind()
        if W > 1 and self._procs is not None:
            states, self.state_bytes = self._gather_states(
                states[self._procs.rank])
        else:
            self.state_bytes = state_bytes(states)
        state = self._unshard(states) if self._sharded else states[0]
        if self._replay_service is not None:
            # the flat buffer again: fit()'s result and checkpoints do
            # not depend on the plan
            service = self._replay_service
            state = self._swap_replay(
                state, service.unshard_state(state.extra["replay"]))
        return state, history
