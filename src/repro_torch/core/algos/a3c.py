"""A3C (survey §3.1/Fig. 4c): advantage actor-critic on n-step returns
(the port of src/repro/core/algos/a3c.py).

The asynchronous actor-learner threads are modeled two ways, as in the
reference: under the Trainer with an asp plan, each data position
computes its gradients against a stale copy of the network (the delay
schedule); and `A3C.hogwild_update` applies several threads' gradients,
each taken against its own stale copy, one after another (the
reproducible rendering of lock-free updates)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.advantages import nstep_return
from repro_torch.core.agent import (PolicyGradientAgent, register,
                                    value_and_grad)
from repro_torch.core.networks import make_policy
from repro_torch.optim import adamw, clip_by_global_norm


@dataclasses.dataclass(frozen=True)
class A3C:
    policy: object
    gamma: float = 0.99
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    # the n-step targets run on the discounted-return kernel (forward and
    # adjoint) for CUDA tensors, as the reference always asks for it;
    # False runs the plain scan on the card too (a cross-check)
    use_kernel: bool = True

    def loss(self, params, traj, bootstrap_obs):
        """n-step returns from a time-major on-policy trajectory. The
        target keeps its gradient into the bootstrap value (a3c.py:40-44):
        only the advantage is detached."""
        T, B = traj["reward"].shape
        obs_flat = traj["obs"].reshape((-1,) + traj["obs"].shape[2:])
        act_flat = traj["action"].reshape((-1,)
                                          + traj["action"].shape[2:])
        logp, v, ent = self.policy.log_prob(params, obs_flat, act_flat)
        logp, v, ent = (a.reshape(T, B) for a in (logp, v, ent))
        _, boot = self.policy.apply(params, bootstrap_obs)
        ret = nstep_return(traj["reward"], traj["done"], boot, self.gamma,
                           use_kernel=self.use_kernel)
        adv = (ret - v).detach()
        return (-torch.mean(logp * adv)
                + self.vf_coef * torch.mean(torch.square(v - ret))
                - self.ent_coef * torch.mean(ent))

    def hogwild_update(self, params, opt_state, trajs, boot_obs,
                       delays_params, optimizer, n_threads):
        """Apply n_threads gradient contributions in thread order; thread
        i's gradient is taken against `delays_params` row i (its stale
        copy) on its trajectory `trajs` row i and bootstrap `boot_obs`
        row i. Every argument but the optimizer is a dict of tensors
        with a leading thread dim where it has one."""
        for i in range(n_threads):
            row = lambda t: {k: v[i] for k, v in t.items()}
            _, grads = value_and_grad(self.loss, row(delays_params),
                                      row(trajs), boot_obs[i])
            params, opt_state = optimizer.apply(params, opt_state, grads)
        return params, opt_state


class A3CAgent(PolicyGradientAgent):
    """A3C behind the unified protocol."""

    def __init__(self, env, ring_size=1, total_iters=None, lr=1e-3,
                 hidden=(64, 64), max_grad_norm=1.0, policy="mlp",
                 trunk_kwargs=None, device="cuda", **algo_kwargs):
        self.policy = make_policy(env.spec, policy, hidden, device=device,
                                  **(trunk_kwargs or {}))
        self.algo = A3C(self.policy, **algo_kwargs)
        self.opt = clip_by_global_norm(adamw(lr), max_grad_norm)
        self.ring_size = ring_size


register("a3c", A3CAgent)
