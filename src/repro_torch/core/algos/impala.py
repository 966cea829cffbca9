"""IMPALA actor-learner with V-trace (survey §3.2/§6.1), the port of
src/repro/core/algos/impala.py.

The policy lag between the behavior policy (actor params) and the target
policy (learner params) comes from the Trainer's lag ring, and V-trace
corrects for it; `use_vtrace=False` keeps the reference's uncorrected
baseline.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.advantages import discounted_return
from repro_torch.core.agent import PolicyGradientAgent, register
from repro_torch.core.networks import make_policy
from repro_torch.core.vtrace import epsilon_correction, vtrace
from repro_torch.optim import adamw, clip_by_global_norm


@dataclasses.dataclass(frozen=True)
class IMPALA:
    policy: object
    gamma: float = 0.99
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    clip_rho: float = 1.0
    clip_c: float = 1.0
    use_vtrace: bool = True
    use_eps_correction: bool = False
    # the V-trace targets (and the naive branch's discounted return) run
    # on their CUDA kernels for CUDA tensors: the reference's plain
    # V-trace is a lax.scan that XLA compiles into one fused loop, whose
    # counterpart here is the kernel, not an eager loop of ~110 small
    # launches a step; False runs the plain versions on the card too (a
    # cross-check)
    use_kernel: bool = True

    def loss(self, params, traj, bootstrap_obs):
        """traj: time-major {obs, action, logp(behavior), reward, done}."""
        T, B = traj["reward"].shape
        obs_flat = traj["obs"].reshape((-1,) + traj["obs"].shape[2:])
        act_flat = traj["action"].reshape((-1,)
                                          + traj["action"].shape[2:])
        logp_t, v_t, ent = self.policy.log_prob(params, obs_flat, act_flat)
        if self.use_eps_correction:
            logp_t = epsilon_correction(logp_t)
        logp_t = logp_t.reshape(T, B)
        v_t = v_t.reshape(T, B)
        ent = ent.reshape(T, B)
        _, boot = self.policy.apply(params, bootstrap_obs)
        discounts = self.gamma * (1.0 - traj["done"].to(torch.float32))
        if self.use_vtrace:
            log_rhos = logp_t - traj["logp"]
            vs, pg_adv = vtrace(log_rhos.detach(), discounts,
                                traj["reward"], v_t.detach(), boot,
                                self.clip_rho, self.clip_c,
                                use_kernel=self.use_kernel)
        else:  # naive on-policy targets computed from off-policy data
            vs = discounted_return(traj["reward"], discounts, boot.detach(),
                                   use_kernel=self.use_kernel)
            vs_tp1 = torch.cat([vs[1:], boot[None]], dim=0)
            pg_adv = (traj["reward"] + discounts * vs_tp1
                      - v_t.detach()).detach()
        pg_loss = -torch.mean(logp_t * pg_adv)
        vf_loss = torch.mean(torch.square(v_t - vs))
        return pg_loss + self.vf_coef * vf_loss \
            - self.ent_coef * torch.mean(ent)


class IMPALAAgent(PolicyGradientAgent):
    """IMPALA behind the unified protocol. The Trainer's `policy_lag`
    supplies the lag that V-trace corrects for."""

    def __init__(self, env, ring_size=1, total_iters=None, lr=1e-3,
                 hidden=(64, 64), max_grad_norm=1.0, policy="mlp",
                 trunk_kwargs=None, device="cuda", **algo_kwargs):
        self.policy = make_policy(env.spec, policy, hidden, device=device,
                                  **(trunk_kwargs or {}))
        self.algo = IMPALA(self.policy, **algo_kwargs)
        self.opt = clip_by_global_norm(adamw(lr), max_grad_norm)
        self.ring_size = ring_size


register("impala", IMPALAAgent)
