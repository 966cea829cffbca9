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

The partition protocol serves ZeRO learner-state sharding
(core/topology.py): `partition_spec` names the params the optimizer
updates, `flatten_and_pad` turns them into one vector of equal chunks in
the reference's `ravel_pytree` order, and `partition_list` splits them
per transformer block for layer-wise ZeRO-3.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.tracing import span


class PartitionList(list):
    """A per-block partition: the optimizer target split into entries
    that shard on their own (layer-wise ZeRO-3), transformer blocks
    first, the non-block remainder last."""


def _ravel_key(key: str):
    """The sort key that puts flat key paths in `ravel_pytree`'s leaf
    order over the reference's tree: dict keys sorted, list items by
    index, depth first. A per-block `stack/<r>` segment is the
    reference's stacked leading dim, so block r of a leaf sorts after
    its other segments (its blocks lie contiguous, in block order)."""
    parts = key.split("/")
    block = ()
    for i in range(len(parts) - 1):
        if parts[i] == "stack" and parts[i + 1].isdigit():
            block = ((0, int(parts[i + 1]), ""),)
            parts = parts[:i + 1] + parts[i + 2:]
            break
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in parts) + block


def flatten_and_pad(tree, n_shards: int):
    """Flat params -> ONE 1-D vector zero-padded to a multiple of
    `n_shards`, its leaves in the reference's `ravel_pytree` order, so
    chunk r holds the coordinates the reference's chunk r holds.

    Returns ``(vec, size, unravel)``: `vec` the padded vector, `size`
    its unpadded length, and ``unravel(vec[:size])`` the dict again, in
    `tree`'s own key order, each leaf in its own storage and dtype.
    Mixed dtypes promote as `ravel_pytree` promotes them."""
    order = sorted(tree, key=_ravel_key)
    if not order or sum(tree[k].numel() for k in order) == 0:
        raise ValueError("cannot shard an empty parameter pytree")
    dtype = tree[order[0]].dtype
    for k in order[1:]:
        dtype = torch.promote_types(dtype, tree[k].dtype)
    vec = torch.cat([tree[k].reshape(-1).to(dtype) for k in order])
    size = vec.numel()
    pad = (-size) % n_shards
    if pad:
        vec = torch.cat([vec, vec.new_zeros((pad,))])
    offsets, off = {}, 0
    for k in order:
        offsets[k] = off
        off += tree[k].numel()
    spec = [(k, offsets[k], tuple(tree[k].shape), tree[k].numel(),
             tree[k].dtype) for k in tree]

    def unravel(flat):
        return {k: flat[o:o + n].reshape(shape).to(dt).clone()
                for k, o, shape, n, dt in spec}

    return vec, size, unravel


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
    with torch.enable_grad(), span("repro_torch.rl.learner.loss"):
        out = loss_fn(leaves, *args)
    loss = out[0] if has_aux else out
    keys = [k for k, v in leaves.items() if v.requires_grad]
    with span("repro_torch.rl.learner.backward"):
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

    # -- the partition protocol (ZeRO, core/topology.py) -----------------
    def partition_spec(self, state: TrainState):
        """The params the optimizer updates, what `opt_state` mirrors and
        a shard-role axis partitions. Default: all of them (DQN: only the
        online net)."""
        return state.params

    def replace_partition(self, params, sub):
        """`params` with the partition replaced by `sub` (None: removed).
        Default (the partition is all of params): `sub`."""
        return sub

    def partition_list(self, part):
        """The partition `part` (or any tree keyed like it, such as a
        ring slot) split per block for layer-wise ZeRO-3, through the
        policy's `partition_list` hook; None where the policy has no
        block structure (the whole-vector path)."""
        split = getattr(self.policy, "partition_list", None)
        if split is None:
            return None
        parts = split(part)
        return None if parts is None else PartitionList(parts)

    def merge_partition_list(self, entries):
        """Inverse of `partition_list` (the policy's hook)."""
        return self.policy.merge_partition_list(entries)

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
