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
the reference's `_reshard_envs`. The shard/zero3 roles larger than 1
(ROADMAP queue 1, item 12) and the pipelined mode (item 11) are refused
by name.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import agent as agent_api
from repro_torch.core.distribution import DistPlan
from repro_torch.core.networks import splitmix64
from repro_torch.core.positions import PositionGroup, tree_map
from repro_torch.core.replay import PrioritizedReplay
from repro_torch.core.replay_service import ShardedPrioritizedReplay
from repro_torch.core.rollout import rollout
from repro_torch.core.topology import member_sum

_M64 = (1 << 64) - 1


def stream_seed(seed: int, *ids: int) -> int:
    """A 63-bit generator seed that is a pure function of (seed, *ids)."""
    with np.errstate(over="ignore"):
        x = splitmix64(np.array([seed & _M64], np.uint64))
        for i in ids:
            x = splitmix64(x ^ np.uint64(i & _M64))
    return int(x[0]) >> 1


# the per-iteration streams, and the set-up streams (iteration -1); an
# elastic reshard's fresh envs draw from (-1, _RESHARD, superstep window)
_ROLL, _LEARN, _INIT, _ENV, _DELAY, _RESHARD = 0, 1, 2, 3, 4, 5


def plan_refusal(plan: DistPlan) -> Optional[str]:
    """Why this Trainer cannot run `plan`, naming the ROADMAP item that
    ports it; None when it can."""
    for ax in plan.axes:
        if ax.size > 1 and ax.role in ("shard", "zero3"):
            return (f"{ax.role}-role axis {ax.name!r} of size {ax.size} "
                    f"is not ported yet: learner-state sharding comes "
                    f"with the sharded learner-state slice (ROADMAP "
                    f"queue 1, item 12)")
    return None


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
    pipeline: bool = False     # decoupled actor-learner: a later slice
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

    def __init__(self, env, cfg: TrainerConfig, device="cuda"):
        plan = cfg.resolved_plan()
        msg = plan_refusal(plan)
        if msg is not None:
            raise ValueError(f"TrainerConfig.plan {plan.describe()!r}: {msg}")
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
        # every position lives on this one device
        self.device = plan.validate_devices(device)
        self.env = env
        self.cfg = cfg
        self.plan = plan
        self.agent = agent_api.make(cfg.algo, env=env,
                                    ring_size=cfg.ring_size,
                                    total_iters=cfg.iters,
                                    device=self.device, **cfg.algo_kwargs)
        self._replay_service = None
        self.partition_replay = None
        rax = plan.replay_axis
        if rax is not None and rax.size > 1:
            self._swap_in_replay_service(rax)
        if cfg.pipeline:
            raise ValueError("TrainerConfig.pipeline: the decoupled "
                             "actor-learner pipeline is ported with the "
                             "pipeline slice (ROADMAP queue 1, item 11)")
        # the data positions: the env grid's, row-major (replay axis 0)
        self.n_positions = plan.sim_devices
        self._coords = plan.sim_coords()
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

    def _init_all(self):
        """Every position's TrainState, sim carry and delay list."""
        cfg = self.cfg
        W = self.n_positions
        init_gen = torch.Generator().manual_seed(
            stream_seed(cfg.seed, -1, _INIT))
        state = self.agent.init(init_gen)
        if self._replay_service is not None:
            # the flat buffer the agent inits, sharded over the group
            service = self._replay_service
            state = self._swap_replay(
                state, service.shard_state(state.extra["replay"]))
        # the positions share the initial tensors: every update is
        # functional, so each position's first step makes its own
        states = [state] * W
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
    def _run(self, states, sims, delays, start, k, group):
        """Iterations start .. start + k - 1 at every position, updating
        `states` and `sims` in place; returns each position's list of
        per-iteration metrics."""
        def work(r):
            state, sim, per = states[r], sims[r], []
            for it in range(start, start + k):
                state, sim, metrics = self._iteration(state, sim, it,
                                                      delays[r][it], r)
                per.append(metrics)
            states[r], sims[r] = state, sim
            return per

        if group is None:
            return [work(0)]
        grad = torch.is_grad_enabled()

        def in_thread(r):   # the caller's grad mode and current device
            with torch.set_grad_enabled(grad), (
                    torch.cuda.device(self.device)
                    if self.device.type == "cuda"
                    else contextlib.nullcontext()):
                return work(r)

        return group.run(in_thread)

    def fit(self, fused: bool = True):
        """Train for cfg.iters iterations. Returns (TrainState, history);
        with more than one data position, position 0's state."""
        cfg = self.cfg
        W = self.n_positions
        states, sims, delays = self._init_all()
        group = None
        if W > 1:
            group = PositionGroup(W)
            grad_fn, param_fn = self._collectives
            lead = self.plan.sim_shape
            self._hooks = [
                (grad_fn and group.hook(r, grad_fn, lead),
                 param_fn and group.hook(r, param_fn, lead))
                for r in range(W)]
        K = cfg.superstep if fused else 1
        history = []
        start = 0
        self.actor_shards = []
        try:
            while start < cfg.iters:
                k = min(K, cfg.iters - start)
                # the schedule's window is the cfg.superstep-iteration
                # window, not the dispatch: fused and unfused fits
                # reshard at the same iterations
                s_idx = start // cfg.superstep
                n_envs = self.plan.actor_schedule(s_idx, cfg.n_envs)
                sims = self._reshard_envs(sims, n_envs, s_idx)
                self.actor_shards.append(n_envs)
                per = self._run(states, sims, delays, start, k, group)
                names = sorted(per[0][0])
                stacked = [torch.stack([torch.stack([m[n] for m in p])
                                        for n in names]) for p in per]
                # positions averaged each iteration, in rank order
                values = (stacked[0] if W == 1
                          else member_sum(torch.stack(stacked)) / W)
                values = values.cpu()                  # ONE host sync
                for j in range(k):
                    it = start + j
                    if it % cfg.log_every == 0 or it == cfg.iters - 1:
                        history.append({"iter": it, **{
                            n: round(float(values[i, j]), 4)
                            for i, n in enumerate(names)}})
                start += k
        finally:
            if group is not None:
                group.close()
                self._hooks = [(None, None)] * W
        state = states[0]
        if self._replay_service is not None:
            # the flat buffer again: fit()'s result and checkpoints do
            # not depend on the plan
            service = self._replay_service
            state = self._swap_replay(
                state, service.unshard_state(state.extra["replay"]))
        return state, history
