"""Batched environment API (the port of src/repro/envs/api.py).

Environments are functions over a dict of tensors with a leading env
dim, which takes the place of the reference's `jax.vmap`: `reset`,
`step` and `step_autoreset` all act on a whole batch, on the device of
the generator or state they are given.

  * every env publishes an `EnvSpec` (repro_torch.envs.spec);
  * scenario batching: constructors accept physics/layout overrides
    (`scenario=`) and per-episode randomization bounds (`ranges=`). The
    sampled scenario lives inside the env state under `state["scn"]`,
    one row per env, so one batch mixes scenario variants;
  * `step_autoreset` returns the pre-reset terminal observation, and
    `autoreset_merge` is the hook wrappers use to carry state across
    episode boundaries.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.envs.spec import EnvSpec


def tree_map(fn, *trees):
    """Map `fn` over the leaves of nested dicts of tensors."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class Env:
    """Batched environment. Subclasses implement `spec`,
    `reset_scenario(generator, scn)`, `obs` and `step` (reading
    physics/layout from `state["scn"]`), and optionally
    `default_scenario` / `sample_scenario`."""

    def __init__(self, scenario=None, ranges=None):
        base = {k: torch.as_tensor(v)
                for k, v in self.default_scenario().items()}
        for k, v in (scenario or {}).items():
            if k not in base:
                raise KeyError(f"unknown scenario field {k!r}; "
                               f"available: {sorted(base)}")
            base[k] = torch.as_tensor(v, dtype=base[k].dtype)
        for k in (ranges or {}):
            if k not in base:
                raise KeyError(f"unknown scenario range {k!r}; "
                               f"available: {sorted(base)}")
        self._scenario = base
        self._ranges = dict(ranges or {})
        self._scenario_on = {}   # device -> the scenario moved there

    # -- the contract --------------------------------------------------
    @property
    def spec(self) -> EnvSpec:
        raise NotImplementedError

    def reset_scenario(self, generator, scn) -> dict:
        """Initial batched state (without "scn") for scenarios `scn`."""
        raise NotImplementedError

    def obs(self, state) -> torch.Tensor:
        raise NotImplementedError

    def step(self, state, action) -> Tuple[dict, torch.Tensor,
                                           torch.Tensor, torch.Tensor]:
        """-> (state, obs, reward, done), all batched."""
        raise NotImplementedError

    @property
    def obs_dim(self) -> int:
        return self.spec.obs_dim

    @property
    def n_actions(self) -> int:
        return self.spec.n_actions

    @property
    def act_dim(self) -> int:
        return self.spec.act_dim

    # -- scenario batching ---------------------------------------------
    def default_scenario(self) -> dict:
        """Physics/layout parameters; {} = scenario-free env."""
        return {}

    def sample_scenario(self, generator, n) -> dict:
        """Draw `n` scenarios: base values with `ranges` entries sampled
        uniformly (integers inclusive, floats half-open) per episode."""
        dev = generator.device
        if dev not in self._scenario_on:  # one host-to-device copy
            self._scenario_on[dev] = {k: v.to(dev)
                                      for k, v in self._scenario.items()}
        scn = {k: v.expand((n,) + v.shape).clone()
               for k, v in self._scenario_on[dev].items()}
        for name in sorted(self._ranges):
            lo, hi = self._ranges[name]
            base = scn[name]
            if base.dtype.is_floating_point:
                u = torch.rand(base.shape, generator=generator, device=dev,
                               dtype=base.dtype)
                scn[name] = u * (hi - lo) + lo
            else:
                scn[name] = torch.randint(int(lo), int(hi) + 1, base.shape,
                                          generator=generator, device=dev,
                                          dtype=base.dtype)
        return scn

    def reset(self, generator, n) -> dict:
        """Sample `n` scenarios, then the initial state for each; the
        drawn scenario rides in `state["scn"]`."""
        scn = self.sample_scenario(generator, n)
        state = dict(self.reset_scenario(generator, scn))
        state["scn"] = scn
        return state

    def autoreset_merge(self, fresh, new_state, sel):
        """Merge fresh (reset) and stepped state at episode boundaries;
        `sel(a, b)` picks a where the episode ended."""
        return tree_map(sel, fresh, new_state)

    def step_autoreset(self, state, action, generator):
        """Step with per-env auto-reset on done. Returns `(state, obs,
        reward, done)` where `obs` is the **pre-reset** observation from
        `step` (at done steps the terminal one); the new episode's
        observation is `obs(state)`."""
        new_state, obs, reward, done = self.step(state, action)
        fresh = self.reset(generator, done.shape[0])

        def sel(a, b):
            return torch.where(done.reshape((-1,) + (1,) * (a.ndim - 1)),
                               a, b)

        state = self.autoreset_merge(fresh, new_state, sel)
        return state, obs, reward, done
