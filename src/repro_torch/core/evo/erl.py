"""Hybrid evolution-guided RL (Khadka & Tumer 2018; survey §7.3), the port
of src/repro/core/evo/erl.py.

A GA population of policies explores and fills a shared replay buffer;
a gradient learner (an actor-critic on the replay data) trains beside it
and is injected into the population every `inject_every` generations,
replacing the worst member. The population is a batch on the device:
(P, n) flat params, its P episodes stepped as one env batch, its
transitions added to the port's UniformReplay in one write.
`step_noise` takes every draw as a tensor; `step` draws them from a
torch.Generator.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import vmap

from repro_torch.core.agent import value_and_grad
from repro_torch.core.evo.es import FlatLayout, top_k
from repro_torch.core.replay import UniformReplay
from repro_torch.core.rollout import freeze_done


@dataclasses.dataclass(frozen=True)
class ERL:
    policy: object                 # an actor-critic (MLPPolicy.for_spec)
    env: object
    pop_size: int = 8
    elite: int = 2
    sigma: float = 0.05
    gamma: float = 0.99
    inject_every: int = 2
    max_steps: int = 200
    replay_capacity: int = 20000

    def init(self, generator):
        """(state, replay): pop_size fresh members and a learner drawn in
        turn from `generator`, and an empty replay on their device."""
        members = [self.policy.init(generator) for _ in range(self.pop_size)]
        learner = self.policy.init(generator)
        layout = FlatLayout.of(learner)
        object.__setattr__(self, "layout", layout)
        replay = UniformReplay(self.replay_capacity)
        spec = self.env.spec
        dev = next(iter(learner.values())).device
        obs_zero = torch.zeros(spec.observation.shape,
                               dtype=spec.observation.dtype, device=dev)
        example = {"obs": obs_zero,
                   "action": torch.zeros((spec.act_dim,), device=dev),
                   "reward": torch.zeros((), device=dev),
                   "next_obs": obs_zero,
                   "done": torch.zeros((), dtype=torch.bool, device=dev)}
        return {"pop": torch.stack([layout.ravel(p) for p in members]),
                "learner": layout.ravel(learner),
                "replay": replay.init(example), "gen": 0}, replay

    # ---- population rollouts also fill the replay buffer --------------
    def evaluate_and_collect(self, state, replay, start, noise):
        """Each member's stochastic episode from `start` (a batch of
        pop_size env states) with its sampling noise `noise` (P,
        max_steps, noise_dim); returns (state with the transitions added
        member by member, (P,) fitnesses)."""
        params = self.layout.unravel(state["pop"])
        s = start
        P = self.pop_size
        done = torch.zeros((P,), dtype=torch.bool, device=noise.device)
        steps, rews = [], []
        for t in range(self.max_steps):
            obs = self.env.obs(s)
            a, _ = vmap(self.policy.sample)(params, obs, noise[:, t])
            ns, nobs, r, nd = self.env.step(s, a)
            steps.append({"obs": obs,
                          "action": a.reshape(P, -1).to(torch.float32),
                          "reward": r, "next_obs": nobs, "done": nd})
            rews.append(torch.where(done, 0.0, r))
            s = freeze_done(done, s, ns)
            done = done | nd
        # member-major, as the reference's vmap over members then reshape
        trans = {k: torch.stack([st[k] for st in steps], dim=1).reshape(
            (P * self.max_steps,) + steps[0][k].shape[1:])
            for k in steps[0]}
        rstate = replay.add_batch(state["replay"], trans)
        return dict(state, replay=rstate), torch.stack(rews, 1).sum(1)

    # ---- gradient learner (advantage-free actor-critic on replay) -----
    def learner_loss(self, params, batch):
        _, v = self.policy.apply(params, batch["obs"])
        v_next = self.policy.apply(params, batch["next_obs"])[1]
        target = batch["reward"] + self.gamma * (
            1 - batch["done"].to(torch.float32)) * v_next.detach()
        td = target - v
        action = (batch["action"][..., 0] if self.policy.discrete
                  else batch["action"])
        logp, _, _ = self.policy.log_prob(params, batch["obs"], action)
        return torch.mean(torch.square(td)) - torch.mean(logp * td.detach())

    def draws(self, generator, learner_updates, batch_size):
        """The generation's draws: start states, sampling noise, parent
        slots in [0, elite), mutation (P, n) standard normal, and the
        replay uniforms (learner_updates, batch_size)."""
        dev = generator.device
        start = self.env.reset(generator, self.pop_size)
        noise = torch.stack([self.policy.sample_noise(generator,
                                                      self.max_steps)
                             for _ in range(self.pop_size)])
        slots = torch.randint(0, self.elite, (self.pop_size,),
                              generator=generator, device=dev)
        mutation = torch.randn((self.pop_size, self.layout.size),
                               generator=generator,
                               device=dev)
        u = torch.rand((learner_updates, batch_size), generator=generator,
                       device=dev)
        return start, noise, slots, mutation, u

    def step(self, state, replay, generator, optimizer, opt_state,
             learner_updates=8, batch_size=128):
        """One ERL generation, its draws from `generator`."""
        return self.step_noise(
            state, replay, optimizer, opt_state,
            *self.draws(generator, learner_updates, batch_size))

    def step_noise(self, state, replay, optimizer, opt_state, start, noise,
                   slots, mutation, u):
        """One ERL generation from its draws (see `draws`); the learner
        takes one update per row of `u`. Returns (state, opt_state,
        fits)."""
        state, fits = self.evaluate_and_collect(state, replay, start, noise)
        # GA: truncation selection + gaussian mutation
        top = top_k(fits, self.elite)
        parents = top[slots]
        pop = state["pop"][parents] + self.sigma * mutation
        pop[0] = state["pop"][top[0]]                     # elitism
        # gradient learner on replay
        lparams = self.layout.unravel(state["learner"])
        for row in u:
            batch, _ = replay.sample_with(state["replay"], row, row.shape[0])
            _, grads = value_and_grad(self.learner_loss, lparams, batch)
            lparams, opt_state = optimizer.apply(lparams, opt_state, grads)
        lflat = self.layout.ravel(lparams)
        # periodic injection: the learner replaces the worst member
        gen = state["gen"] + 1
        if gen % self.inject_every == 0:
            pop[torch.argmin(fits)] = lflat
        state = dict(state, pop=pop, learner=lflat, gen=gen)
        return state, opt_state, fits
