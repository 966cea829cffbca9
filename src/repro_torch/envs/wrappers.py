"""Env wrappers over batched tensors (the port of
src/repro/envs/wrappers.py).

Wrapper state lives inside the batched env-state dict under
`state["wrap"]`, one row per env, and the wrapped env's state nests under
`state["inner"]`; nothing is kept on the wrapper object, so a wrapped
env is still a pure `reset`/`step` over a dict of tensors and wrappers
compose by nesting.

`autoreset_merge` / `wrap_merge` decide what survives an episode
boundary: TimeLimit's step counter resets with the episode, while
ObsNormalize's running mean and variance persist (`wrap_merge` keeps
the stepped state). The statistics are per env, as under the
reference's `vmap`: they are never reduced across the batch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.envs.api import Env, tree_map
from repro_torch.envs.spec import EnvSpec


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _where(cond, a, b):
    """Per-env select: `cond` (n,) broadcast against (n, ...) leaves."""
    return torch.where(cond.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


class Wrapper(Env):
    """Base wrapper: state = {"inner": inner_state, "wrap": own_state}.

    Subclasses override any of `wrap_init` (own state from the inner
    reset state), `obs`, `step`, `wrap_merge` (autoreset persistence)
    and `spec`."""

    def __init__(self, inner: Env):
        self.inner = inner

    @property
    def spec(self) -> EnvSpec:
        return self.inner.spec

    # -- wrapper-state hooks -------------------------------------------
    def wrap_init(self, inner_state) -> dict:
        return {}

    def wrap_merge(self, fresh, new, sel):
        """Merge own state at episode boundaries (default: reset it)."""
        return tree_map(sel, fresh, new)

    # -- Env protocol --------------------------------------------------
    def reset(self, generator, n):
        s = self.inner.reset(generator, n)
        return {"inner": s, "wrap": self.wrap_init(s)}

    def obs(self, state):
        return self.inner.obs(state["inner"])

    def step(self, state, action):
        s, o, r, d = self.inner.step(state["inner"], action)
        return {"inner": s, "wrap": state["wrap"]}, o, r, d

    def autoreset_merge(self, fresh, new_state, sel):
        return {"inner": self.inner.autoreset_merge(
                    fresh["inner"], new_state["inner"], sel),
                "wrap": self.wrap_merge(fresh["wrap"], new_state["wrap"],
                                        sel)}


class TimeLimit(Wrapper):
    """Truncate episodes at `max_steps` (own counter: works on any env,
    including ones whose internal cap is longer or absent)."""

    def __init__(self, inner: Env, max_steps: int):
        super().__init__(inner)
        self.max_steps = max_steps

    @property
    def spec(self):
        inner = self.inner.spec
        cap = (min(inner.episode_len, self.max_steps)
               if inner.episode_len else self.max_steps)
        return inner.replace(episode_len=cap)

    def wrap_init(self, inner_state):
        leaf = _first_leaf(inner_state)
        return {"t": torch.zeros((leaf.shape[0],), dtype=torch.int32,
                                 device=leaf.device)}

    def step(self, state, action):
        s, o, r, d = self.inner.step(state["inner"], action)
        t = state["wrap"]["t"] + 1
        return {"inner": s, "wrap": {"t": t}}, o, r, d | (t >=
                                                          self.max_steps)


class ObsNormalize(Wrapper):
    """Online per-env observation normalization (Welford running mean
    and variance carried in wrapper state; persists across autoresets).
    `count` is one scalar per env, (n,), broadcast against (n, obs)."""

    def __init__(self, inner: Env, eps: float = 1e-4, clip: float = 10.0):
        super().__init__(inner)
        self.eps = eps
        self.clip = clip

    @property
    def spec(self):
        inner = self.inner.spec
        return inner.replace(observation=dataclasses.replace(
            inner.observation, low=-self.clip, high=self.clip))

    def wrap_init(self, inner_state):
        o0 = self.inner.obs(inner_state).to(torch.float32)
        return {"count": torch.ones((o0.shape[0],), device=o0.device),
                "mean": o0, "m2": torch.zeros_like(o0)}

    def wrap_merge(self, fresh, new, sel):
        return new  # running statistics survive episode boundaries

    @staticmethod
    def _per_env(count, o):
        return count.reshape((-1,) + (1,) * (o.ndim - 1))

    def _normalize(self, stats, o):
        count = self._per_env(stats["count"], o)
        var = stats["m2"] / torch.clamp_min(count - 1.0, 1.0)
        return torch.clamp((o - stats["mean"]) / torch.sqrt(var + self.eps),
                           -self.clip, self.clip)

    def obs(self, state):
        return self._normalize(state["wrap"],
                               self.inner.obs(state["inner"]))

    def step(self, state, action):
        s, o, r, d = self.inner.step(state["inner"], action)
        st = state["wrap"]
        count = st["count"] + 1.0
        delta = o - st["mean"]
        mean = st["mean"] + delta / self._per_env(count, o)
        m2 = st["m2"] + delta * (o - mean)
        stats = {"count": count, "mean": mean, "m2": m2}
        return {"inner": s, "wrap": stats}, self._normalize(stats, o), r, d


class RewardScale(Wrapper):
    """Multiply rewards by a constant (stateless)."""

    def __init__(self, inner: Env, scale: float):
        super().__init__(inner)
        self.scale = scale

    def step(self, state, action):
        s, o, r, d = self.inner.step(state["inner"], action)
        return {"inner": s, "wrap": state["wrap"]}, o, r * self.scale, d


class ActionRepeat(Wrapper):
    """Repeat each action `repeat` times, summing rewards; once an
    episode ends mid-repeat its remaining sub-steps are masked out, so
    its terminal observation and state freeze (frame-skip, stateless)."""

    def __init__(self, inner: Env, repeat: int):
        super().__init__(inner)
        if repeat < 1:
            raise ValueError(f"ActionRepeat: repeat {repeat} < 1")
        self.repeat = repeat

    def step(self, state, action):
        s, o, r, d = self.inner.step(state["inner"], action)
        for _ in range(self.repeat - 1):
            ns, no, nr, nd = self.inner.step(s, action)
            # an episode already over: freeze state and obs, no reward
            s = tree_map(lambda a, b: _where(d, a, b), s, ns)
            o = _where(d, o, no)
            r = r + torch.where(d, 0.0, nr)
            d = d | nd
        return {"inner": s, "wrap": state["wrap"]}, o, r, d
