"""Single-device Trainer (the port of src/repro/core/trainer.py for the
one-worker plan).

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

Distribution plans and the pipelined mode are later slices; the Trainer
refuses them by name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import agent as agent_api
from repro_torch.core.networks import splitmix64
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


# the per-iteration streams, and the two set-up streams (iteration -1)
_ROLL, _LEARN, _INIT, _ENV = 0, 1, 2, 3


@dataclasses.dataclass
class TrainerConfig:
    algo: str = "impala"
    iters: int = 60
    superstep: int = 10        # K iterations per dispatch (fused mode)
    n_envs: int = 32           # envs on the one device
    unroll: int = 32           # rollout length T per iteration
    plan: Optional[Any] = None  # distribution plan: a later slice
    policy_lag: int = 0        # deterministic actor-param lag
    seed: int = 0
    log_every: int = 10
    donate: bool = True        # the reference's buffer donation; eager
    #                            PyTorch has none, so it changes nothing
    pipeline: bool = False     # decoupled actor-learner: a later slice
    algo_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ring_size(self) -> int:
        """Actor-param history depth: the lag plus the newest slot."""
        return self.policy_lag + 1


class Trainer:
    """Drives any registered Agent on one device; see module doc."""

    def __init__(self, env, cfg: TrainerConfig, device="cuda"):
        if cfg.plan is not None:
            raise ValueError("TrainerConfig.plan: distribution plans are "
                             "ported with the distribution slice (ROADMAP "
                             "queue 1, item 10); this Trainer runs one "
                             "device")
        if cfg.pipeline:
            raise ValueError("TrainerConfig.pipeline: the decoupled "
                             "actor-learner pipeline is ported with the "
                             "pipeline slice (ROADMAP queue 1, item 11)")
        self.device = resolve_device(device)
        self.env = env
        self.cfg = cfg
        self.agent = agent_api.make(cfg.algo, env=env,
                                    ring_size=cfg.ring_size,
                                    total_iters=cfg.iters,
                                    device=self.device, **cfg.algo_kwargs)
        self._gen = torch.Generator(device=self.device)
        self.actor_shards = []   # env count per superstep dispatch

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

    def _iteration(self, state, sim, it):
        item, env_state = self._produce(state, sim["env"], it)
        state, ep_run, ep_ret, metrics = self._consume(
            state, sim["ep_run"], sim["ep_last"], item, it)
        return state, {"env": env_state, "ep_run": ep_run,
                       "ep_last": ep_ret}, metrics

    def _init_all(self):
        cfg = self.cfg
        init_gen = torch.Generator().manual_seed(
            stream_seed(cfg.seed, -1, _INIT))
        state = self.agent.init(init_gen)
        # ep_last starts NaN: no episode has finished yet
        sim = {"env": self.env.reset(self._generator(-1, _ENV), cfg.n_envs),
               "ep_run": torch.zeros((cfg.n_envs,), device=self.device),
               "ep_last": torch.full((), float("nan"), device=self.device)}
        return state, sim

    # ---- the loop ----------------------------------------------------
    def fit(self, fused: bool = True):
        """Train for cfg.iters iterations. Returns (TrainState, history)."""
        cfg = self.cfg
        state, sim = self._init_all()
        K = cfg.superstep if fused else 1
        history = []
        start = 0
        self.actor_shards = []
        while start < cfg.iters:
            k = min(K, cfg.iters - start)
            self.actor_shards.append(cfg.n_envs)
            per = []
            for it in range(start, start + k):
                state, sim, metrics = self._iteration(state, sim, it)
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
        return state, history
