"""Single-device Trainer (the port of src/repro/core/trainer.py for the
plans that run on one device).

Each iteration is rollout -> learner_step -> lag-ring push over a batch
of envs on one device. `fit(fused=True)` runs `superstep` iterations per
dispatch with the metrics left on the device and read back once per
superstep (one `.cpu()`); `fit(fused=False)` runs one iteration per
dispatch. The loop is eager PyTorch.

Randomness is a pure function of (seed, iteration): every iteration
reseeds the device generator from a hash of the two before its rollout
and again before its learner step, as the reference's `_iter_key` folds
the iteration into its base key. So fused and unfused fits are bitwise
equal by construction.

A `DistPlan` (core/distribution.py) runs here when it has one data
position: every data axis of size 1, with any sync discipline (its delay
schedule, drawn once per fit, feeds `actor_policy(state, delay)` each
iteration), and at most a replay-role axis larger than 1. A replay axis
turns the agent's prioritized buffer into the sharded replay service
(core/replay_service.py), its R members held on the one device; they
replicate the data position's rollout and learner, so the fit is bitwise
the flat fit. Larger data axes, shard/zero3 axes, an elastic `actors=`
schedule and the pipelined mode are later slices; the Trainer refuses
them by name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import agent as agent_api
from repro_torch.core.distribution import DistPlan
from repro_torch.core.networks import splitmix64
from repro_torch.core.replay import PrioritizedReplay
from repro_torch.core.replay_service import ShardedPrioritizedReplay
from repro_torch.core.rollout import rollout
from repro_torch.kernels.common import resolve_device

_M64 = (1 << 64) - 1


def stream_seed(seed: int, *ids: int) -> int:
    """A 63-bit generator seed that is a pure function of (seed, *ids)."""
    with np.errstate(over="ignore"):
        x = splitmix64(np.array([seed & _M64], np.uint64))
        for i in ids:
            x = splitmix64(x ^ np.uint64(i & _M64))
    return int(x[0]) >> 1


# the per-iteration streams, and the set-up streams (iteration -1)
_ROLL, _LEARN, _INIT, _ENV, _DELAY = 0, 1, 2, 3, 4

_MULTI_DEVICE = ("the multi-device distribution slice (ROADMAP queue 1, "
                 "item 10)")


def plan_refusal(plan: DistPlan, n_envs: int) -> Optional[str]:
    """Why this one-device Trainer cannot run `plan`, naming the slice
    that ports it; None when it can."""
    for ax in plan.axes:
        if ax.size == 1 or ax.role == "replay":
            continue
        if ax.role == "data":
            return (f"data axis {ax.name!r} of size {ax.size} "
                    f"({ax.collective} collective, {ax.sync} sync) is not "
                    f"ported yet: data axes larger than 1 come with "
                    f"{_MULTI_DEVICE}; this Trainer holds one data "
                    f"position on one device")
        return (f"{ax.role}-role axis {ax.name!r} of size {ax.size} is not "
                f"ported yet: learner-state sharding comes with the "
                f"sharded learner-state slice (ROADMAP queue 1, item 12)")
    if plan.actors is not None and set(plan.actors) != {n_envs}:
        return (f"actors= schedule {list(plan.actors)} is not ported yet: "
                f"an elastic schedule that changes the env count from "
                f"n_envs={n_envs} comes with {_MULTI_DEVICE}")
    return None


@dataclasses.dataclass
class TrainerConfig:
    algo: str = "impala"
    iters: int = 60
    superstep: int = 10        # K iterations per dispatch (fused mode)
    n_envs: int = 32           # envs on the one device
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
    """Drives any registered Agent on one device; see module doc."""

    def __init__(self, env, cfg: TrainerConfig, device="cuda"):
        plan = cfg.resolved_plan()
        msg = plan_refusal(plan, cfg.n_envs)
        if msg is not None:
            raise ValueError(f"TrainerConfig.plan {plan.describe()!r}: {msg}")
        self.device = resolve_device(device)
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
        self._gen = torch.Generator(device=self.device)
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

    def _generator(self, it: int, stream: int):
        """The device generator, reseeded for (iteration, stream)."""
        return self._gen.manual_seed(stream_seed(self.cfg.seed, it, stream))

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
    def _produce(self, state, env_state, it, delay=None):
        """One trajectory for iteration `it` plus its bootstrap
        observation, acting with the params `delay` updates old."""
        delay = self.cfg.policy_lag if delay is None else delay
        gen = self._generator(it, _ROLL)
        actor = self.agent.actor_policy(state, delay)
        traj, env_state = rollout(self.agent.policy, actor, self.env, gen,
                                  env_state, self.cfg.unroll)
        return {"traj": traj, "boot": self.env.obs(env_state)}, env_state

    def _consume(self, state, ep_run, ep_last, item, it):
        """One learner_step on an item plus the episode accounting."""
        gen = self._generator(it, _LEARN)
        state, metrics = self.agent.learner_step(state, item["traj"],
                                                 item["boot"], gen)
        ep_run, ep_ret = self._episode_stats(ep_run, ep_last, item["traj"])
        return state, ep_run, ep_ret, dict(metrics, episode_return=ep_ret)

    def _iteration(self, state, sim, it, delay=None):
        item, env_state = self._produce(state, sim["env"], it, delay)
        state, ep_run, ep_ret, metrics = self._consume(
            state, sim["ep_run"], sim["ep_last"], item, it)
        return state, {"env": env_state, "ep_run": ep_run,
                       "ep_last": ep_ret}, metrics

    def _init_all(self):
        cfg = self.cfg
        init_gen = torch.Generator().manual_seed(
            stream_seed(cfg.seed, -1, _INIT))
        state = self.agent.init(init_gen)
        if self._replay_service is not None:
            # the flat buffer the agent inits, sharded over the group
            service = self._replay_service
            state = self._swap_replay(
                state, service.shard_state(state.extra["replay"]))
        # ep_last starts NaN: no episode has finished yet
        sim = {"env": self.env.reset(self._generator(-1, _ENV), cfg.n_envs),
               "ep_run": torch.zeros((cfg.n_envs,), device=self.device),
               "ep_last": torch.full((), float("nan"), device=self.device)}
        # the plan's per-axis delays add; every member of the one data
        # position (a replay group replicates it) acts with the same one,
        # so it is read at mesh coordinates (0, ..., 0). A host list: the
        # ring read takes a Python int
        delay_gen = torch.Generator().manual_seed(
            stream_seed(cfg.seed, -1, _DELAY))
        schedule = self.plan.make_delay_schedule(cfg.iters, delay_gen)
        delays = (schedule.reshape(cfg.iters, -1)[:, 0]
                  + cfg.policy_lag).tolist()
        return state, sim, delays

    @staticmethod
    def _swap_replay(state, rstate):
        return agent_api.TrainState(state.params, state.opt_state,
                                    dict(state.extra, replay=rstate),
                                    state.ring, state.steps)

    # ---- the loop ----------------------------------------------------
    def fit(self, fused: bool = True):
        """Train for cfg.iters iterations. Returns (TrainState, history)."""
        cfg = self.cfg
        state, sim, delays = self._init_all()
        K = cfg.superstep if fused else 1
        history = []
        start = 0
        self.actor_shards = []
        while start < cfg.iters:
            k = min(K, cfg.iters - start)
            self.actor_shards.append(cfg.n_envs)
            per = []
            for it in range(start, start + k):
                state, sim, metrics = self._iteration(state, sim, it,
                                                      delays[it])
                per.append(metrics)
            names = sorted(per[0])
            values = torch.stack([torch.stack([m[n] for m in per])
                                  for n in names]).cpu()  # ONE host sync
            for j in range(k):
                it = start + j
                if it % cfg.log_every == 0 or it == cfg.iters - 1:
                    history.append({"iter": it, **{
                        n: round(float(values[i, j]), 4)
                        for i, n in enumerate(names)}})
            start += k
        if self._replay_service is not None:
            # the flat buffer again: fit()'s result and checkpoints do
            # not depend on the plan
            service = self._replay_service
            state = self._swap_replay(
                state, service.unshard_state(state.extra["replay"]))
        return state, history
