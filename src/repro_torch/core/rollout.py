"""Actor-side batched rollout engine (the port of
src/repro/core/rollout.py).

One Python loop advances B environments T steps: policy inference, env
dynamics and auto-reset, all on the generator's device. Each step runs
ONE policy forward (`sample_value` gives action, log-prob and value) and
draws its noise and its resets from a `torch.Generator`.
"""
from __future__ import annotations

import torch

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
        obs = env.obs(env_state)
        noise = policy.sample_noise(generator, obs.shape[0])
        action, logp, value = policy.sample_value(params, obs, noise)
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
