"""Actor-side batched rollout engine (the port of
src/repro/core/rollout.py).

One Python loop advances B environments T steps: policy inference, env
dynamics and auto-reset, all on the generator's device. Each step runs
ONE policy forward (`sample_value` gives action, log-prob and value) and
draws its noise and its resets from a `torch.Generator`.

`episode_return` is the evolution methods' fitness: one greedy episode
per population member, the members' params a leading dim and their envs
one batch, which takes the place of the reference's `vmap`.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from repro_torch.envs.api import tree_map
from repro_torch.tracing import span

TRAJ_KEYS = ("obs", "action", "logp", "value", "reward", "done",
             "next_obs")


@torch.no_grad()
def rollout(policy, params, env, generator, env_state, T):
    """Collect T steps from a batch of envs.

    Returns (trajectory, final_env_state). Trajectory tensors are
    time-major (T, B, ...): obs, action, logp, value, reward, done,
    next_obs. `next_obs` is the TRUE successor observation: at `done`
    steps it is the pre-autoreset terminal obs (Env.step_autoreset), so
    bootstrap consumers never see the fresh-reset obs at an episode
    boundary."""
    steps = {k: [] for k in TRAJ_KEYS}
    for _ in range(T):
        with span("repro_torch.rl.rollout.policy"):
            obs = env.obs(env_state)
            noise = policy.sample_noise(generator, obs.shape[0])
            action, logp, value = policy.sample_value(params, obs, noise)
        with span("repro_torch.rl.rollout.env"):
            env_state, next_obs, reward, done = env.step_autoreset(
                env_state, action, generator)
        for k, v in zip(TRAJ_KEYS, (obs, action, logp, value, reward, done,
                                    next_obs)):
            steps[k].append(v)
    return {k: torch.stack(v) for k, v in steps.items()}, env_state


def rollout_fresh(policy, params, env, generator, T, n):
    """Rollout from `n` freshly reset envs."""
    env_state = env.reset(generator, n)
    return rollout(policy, params, env, generator, env_state, T)


def freeze_done(done, old, new):
    """Per-env select of a state tree: `old` where the episode was over
    already (its state frozen), else `new`."""
    return tree_map(lambda a, b: torch.where(
        done.reshape((-1,) + (1,) * (a.ndim - 1)), a, b), old, new)


@torch.no_grad()
def episode_return(policy, params, env, generator=None, max_steps=200,
                   state=None):
    """One deterministic episode return per population member (greedy
    for a discrete head, the mean action for a continuous one, squashed
    into the action box read off the env's spec): params with a leading
    (P,) member dim; the P envs start from `state` (a batched env state)
    or from `env.reset(generator, P)`. Rewards after an episode's end
    are masked and its state frozen. Returns (P,) float32."""
    P = next(iter(params.values())).shape[0]
    if state is None:
        state = env.reset(generator, P)
    act = env.spec.action
    done = torch.zeros((P,), dtype=torch.bool,
                       device=next(iter(params.values())).device)
    total = torch.zeros((P,), device=done.device)
    for _ in range(max_steps):
        pi, _ = vmap(policy.apply)(params, env.obs(state))
        if policy.discrete:
            action = torch.argmax(pi, dim=-1).to(torch.int32)
        else:
            action = act.midpoint + torch.tanh(pi) * act.half_range
        nstate, _, reward, ndone = env.step(state, action)
        total = total + torch.where(done, 0.0, reward)
        state = freeze_done(done, state, nstate)
        done = done | ndone
    return total
