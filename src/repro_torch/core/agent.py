"""Unified Agent protocol + registry (the port of src/repro/core/agent.py).

Every algorithm trains behind the same three methods, so one training
loop (`repro_torch.core.trainer.Trainer`) runs any of them:

    init(generator)               -> TrainState
    actor_policy(state, delay)    -> behavior params for the rollout,
                                     `delay` learner-updates old
    learner_step(state, traj, boot_obs, generator,
                 grad_tx=None, param_tx=None)
                                  -> (TrainState, metrics)

`grad_tx` and `param_tx` are the Trainer's collectives for a plan with
more than one data position (core/positions.py): `grad_tx` exchanges the
gradients before the optimizer update, `param_tx` mixes the params after
it (gossip). A one-position fit passes neither.

Params are flat dicts of tensors named by the JAX key path; the policy
lag is a ring of stacked actor params inside TrainState, slot 0 the
newest. Algorithms self-register by name when `repro_torch.core.algos` is
imported; `make("impala", env=env, ...)` constructs one from config.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


@dataclasses.dataclass
class TrainState:
    """The train state every algorithm flows through."""
    params: Dict[str, torch.Tensor]  # learner params, JAX key paths
    opt_state: Any                   # dict: "step" and per-param moments
    extra: Dict[str, Any]            # algorithm-private state
    ring: Dict[str, torch.Tensor]    # (ring_size, ...) actor params, [0] newest
    steps: torch.Tensor              # int32 learner-update counter


def value_and_grad(loss_fn, params, *args, has_aux=False):
    """(loss, grads) of `loss_fn(params, *args)` with respect to every
    floating param; a param the loss does not reach gets a zero gradient,
    as under jax.grad. With `has_aux`, `loss_fn` returns (loss, aux) and
    the result is ((loss, aux), grads)."""
    leaves = {k: v.detach().requires_grad_(v.is_floating_point())
              for k, v in params.items()}
    with torch.enable_grad():
        out = loss_fn(leaves, *args)
    loss = out[0] if has_aux else out
    keys = [k for k, v in leaves.items() if v.requires_grad]
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(keys, grads)}
    value = (loss.detach(), out[1]) if has_aux else loss.detach()
    return value, grads


class Agent:
    """Base class: the lag-ring plumbing shared by all agents.

    Subclasses set `self.policy` (with `sample_value`/`apply` for the
    rollout) and `self.ring_size`, and implement `init` and
    `learner_step`."""

    policy: Any
    ring_size: int = 1

    def init(self, generator) -> TrainState:
        raise NotImplementedError

    def learner_step(self, state, traj, boot_obs, generator,
                     grad_tx=None, param_tx=None):
        raise NotImplementedError

    def actor_policy(self, state: TrainState, delay=0):
        """Behavior params `delay` learner-updates old (clipped to the
        ring depth)."""
        return self._ring_read(state.ring, delay)

    # -- lag-ring helpers ----------------------------------------------
    def _ring_init(self, behavior_params):
        return {k: p.expand((self.ring_size,) + p.shape).clone()
                for k, p in behavior_params.items()}

    def _ring_read(self, ring, delay):
        d = min(int(delay), self.ring_size - 1)
        return {k: r[d] for k, r in ring.items()}

    def _ring_push(self, ring, behavior_params):
        """Roll the ring one slot older and put the new params in slot
        0 (the reference's roll-then-set)."""
        return {k: torch.cat([behavior_params[k][None], h[:-1]])
                for k, h in ring.items()}


class PolicyGradientAgent(Agent):
    """Shared init/learner_step for agents whose learner is one gradient
    of ``self.algo.loss(params, traj, boot_obs)`` (A3C, IMPALA; PPO
    reuses `init` and overrides `learner_step`). Subclasses' __init__
    must set `policy`, `algo`, `opt`, `ring_size`."""

    def init(self, generator):
        params = self.policy.init(generator)
        return TrainState(params, self.opt.init(params), {},
                          self._ring_init(params),
                          torch.zeros((), dtype=torch.int32,
                                      device=self.policy.device))

    def learner_step(self, state, traj, boot_obs, generator=None,
                     grad_tx=None, param_tx=None):
        loss, grads = value_and_grad(self.algo.loss, state.params, traj,
                                     boot_obs)
        if grad_tx is not None:
            grads = grad_tx(grads)
        params, opt_state = self.opt.apply(state.params, state.opt_state,
                                           grads)
        if param_tx is not None:
            params = param_tx(params)
        return TrainState(params, opt_state, state.extra,
                          self._ring_push(state.ring, params),
                          state.steps + 1), {"loss": loss}


# ------------------------------------------------------------ registry
_REGISTRY: Dict[str, Callable[..., Agent]] = {}


def register(name: str, factory: Callable[..., Agent]) -> None:
    """Register an Agent factory under `name` (called with env=..., **kw)."""
    _REGISTRY[name] = factory


def available():
    """Names of all registered algorithms."""
    import repro_torch.core.algos  # noqa: F401 — triggers self-registration
    return tuple(sorted(_REGISTRY))


def make(name: str, env, **kwargs) -> Agent:
    """Construct a registered algorithm by name from config. The Trainer
    passes `ring_size`, `total_iters` and `device` alongside any user
    algo_kwargs."""
    import repro_torch.core.algos  # noqa: F401 — triggers self-registration
    if name not in _REGISTRY:
        raise KeyError(f"unknown algorithm {name!r}; available: "
                       f"{', '.join(sorted(_REGISTRY))}")
    return _REGISTRY[name](env=env, **kwargs)
