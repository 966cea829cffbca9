"""PPO with GAE (the port of src/repro/core/algos/ppo.py's loss and
agent)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.advantages import gae
from repro_torch.core.agent import (PolicyGradientAgent, TrainState,
                                    register, value_and_grad)
from repro_torch.core.networks import make_policy
from repro_torch.optim import adamw, clip_by_global_norm
from repro_torch.tracing import spanned


@dataclasses.dataclass(frozen=True)
class PPO:
    policy: object
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    gamma: float = 0.99
    lam: float = 0.95
    # GAE runs on the discounted-return kernel for CUDA tensors, as the
    # reference always asks for it; False runs the plain scan on the
    # card too (a cross-check)
    use_kernel: bool = True

    def loss(self, params, batch):
        """batch: flattened {obs, action, logp, adv, ret}."""
        logp, v, ent = self.policy.log_prob(params, batch["obs"],
                                            batch["action"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        # jnp.std is the population std: ddof 0, not torch's default 1
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - self.clip_eps,
                              1 + self.clip_eps) * adv
        pg = -torch.mean(torch.minimum(unclipped, clipped))
        vf = torch.mean(torch.square(v - batch["ret"]))
        return pg + self.vf_coef * vf - self.ent_coef * torch.mean(ent)

    @torch.no_grad()
    @spanned("repro_torch.rl.learner.targets")
    def make_batch(self, params, traj, last_obs):
        """traj: time-major rollout dict. Computes GAE (through the
        core.advantages seam) outside autograd and flattens."""
        _, boot = self.policy.apply(params, last_obs)
        adv, ret = gae(traj["reward"], traj["value"], traj["done"], boot,
                       self.gamma, self.lam, use_kernel=self.use_kernel)
        flat = lambda a: a.reshape((-1,) + a.shape[2:])
        return {"obs": flat(traj["obs"]), "action": flat(traj["action"]),
                "logp": flat(traj["logp"]), "adv": flat(adv),
                "ret": flat(ret)}

    def update(self, params, opt_state, batch, perms, optimizer,
               n_epochs=4, n_minibatch=4, grad_tx=None):
        """The reference's epoch/minibatch loop over a flattened batch,
        with its (n_epochs, n) minibatch permutations given in place of
        the key: epoch e visits minibatch i as perms[e, i*mb:(i+1)*mb].
        `grad_tx` exchanges every minibatch gradient. Returns (params,
        opt_state, the mean loss)."""
        if perms.shape[0] != n_epochs:
            raise ValueError(f"perms has {perms.shape[0]} rows for "
                             f"{n_epochs} epochs")
        mb = perms.shape[1] // n_minibatch
        losses = []
        for perm in perms:
            for i in range(n_minibatch):
                idx = perm[i * mb:(i + 1) * mb]
                mbatch = {k: v[idx] for k, v in batch.items()}
                loss, grads = value_and_grad(self.loss, params, mbatch)
                if grad_tx is not None:
                    grads = grad_tx(grads)
                params, opt_state = optimizer.apply(params, opt_state,
                                                    grads)
                losses.append(loss)
        loss = torch.stack(losses).reshape(n_epochs, -1).mean(-1).mean()
        return params, opt_state, loss


class PPOAgent(PolicyGradientAgent):
    """PPO behind the unified protocol (shares init with the other
    policy-gradient agents; the learner is its own epoch/minibatch
    loop). With more than one data position the Trainer's grad_tx
    exchanges every minibatch gradient — DD-PPO's decentralized
    synchronous exchange (survey §3.2)."""

    def __init__(self, env, ring_size=1, total_iters=None, lr=3e-4,
                 hidden=(64, 64), n_epochs=4, n_minibatch=4,
                 max_grad_norm=0.5, policy="mlp", trunk_kwargs=None,
                 device="cuda", **algo_kwargs):
        self.policy = make_policy(env.spec, policy, hidden, device=device,
                                  **(trunk_kwargs or {}))
        self.algo = PPO(self.policy, **algo_kwargs)
        self.opt = clip_by_global_norm(adamw(lr), max_grad_norm)
        self.n_epochs = n_epochs
        self.n_minibatch = n_minibatch
        self.ring_size = ring_size

    def learner_step(self, state, traj, boot_obs, generator,
                     grad_tx=None, param_tx=None):
        """Draws one minibatch permutation per epoch from `generator`
        and runs `learner_step_perms`."""
        n = traj["reward"].numel()
        perms = torch.rand((self.n_epochs, n), generator=generator,
                           device=generator.device).argsort(dim=-1,
                                                            stable=True)
        return self.learner_step_perms(state, traj, boot_obs, perms,
                                       grad_tx, param_tx)

    def learner_step_perms(self, state, traj, boot_obs, perms,
                           grad_tx=None, param_tx=None):
        """The learner with its (n_epochs, n) minibatch permutations
        given: epoch e visits minibatch i as perms[e, i*mb:(i+1)*mb].
        `grad_tx` exchanges every minibatch gradient, `param_tx` mixes
        the params once after the epochs."""
        batch = self.algo.make_batch(state.params, traj, boot_obs)
        params, opt_state, loss = self.algo.update(
            state.params, state.opt_state, batch, perms, self.opt,
            len(perms), self.n_minibatch, grad_tx)
        if param_tx is not None:
            params = param_tx(params)
        return TrainState(params, opt_state, state.extra,
                          self._ring_push(state.ring, params),
                          state.steps + 1), {"loss": loss}


register("ppo", PPOAgent)
