"""Evolution Strategies (Salimans et al. 2017; survey §7.1), the port of
src/repro/core/evo/es.py.

Antithetic sampling, rank-shaped fitness, common random numbers. The
survey's scaling observation, that a worker sends ONE scalar fitness per
member and not a gradient vector, is the step's `comm_bytes`.

Params travel as one flat vector in the reference's `ravel_pytree` order
(dict keys sorted, list items in order), so a flat θ and a perturbation
ε mean the same thing in both packages. Every draw has an explicit-noise
entry (`step_noise`); `step` draws it from a torch.Generator.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.rollout import episode_return
from repro_torch.envs.api import tree_map


def _tree_order(key):
    return tuple((0, int(p)) if p.isdigit() else (1, p)
                 for p in key.split("/"))


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Where each param lies in a flat vector: (key, shape, offset, size)
    in the reference's ravel_pytree order."""
    entries: tuple

    @classmethod
    def of(cls, params):
        entries, off = [], 0
        for key in sorted(params, key=_tree_order):
            n = params[key].numel()
            entries.append((key, tuple(params[key].shape), off, n))
            off += n
        return cls(tuple(entries))

    @property
    def size(self):
        _, _, off, n = self.entries[-1]
        return off + n

    def ravel(self, params):
        """The flat (n,) vector of one member's params."""
        return torch.cat([params[k].reshape(-1)
                          for k, _, _, _ in self.entries])

    def unravel(self, theta):
        """Params dict of views into `theta` (..., n), leading dims kept
        (a population's (P, n) gives each param a leading (P,))."""
        lead = theta.shape[:-1]
        return {k: theta[..., off:off + n].reshape(lead + shape)
                for k, shape, off, n in self.entries}


def centered_ranks(x):
    """Fitness shaping: ranks mapped to [-0.5, 0.5] (stable order among
    ties, as jnp.argsort)."""
    ranks = torch.argsort(torch.argsort(x, stable=True), stable=True)
    return ranks.to(torch.float32) / (x.shape[0] - 1) - 0.5


def top_k(x, k):
    """Indices of the k largest entries, largest first, ties in index
    order (jax.lax.top_k's order)."""
    return torch.argsort(x, descending=True, stable=True)[:k]


def common_start(env, generator, n):
    """n copies of one reset env state: every member is evaluated on the
    same episode seed (common random numbers)."""
    one = env.reset(generator, 1)
    return tree_map(lambda a: a.expand((n,) + a.shape[1:]).clone(), one)


@dataclasses.dataclass(frozen=True)
class ES:
    policy: object
    env: object
    pop_size: int = 32            # antithetic pairs: pop_size must be even
    sigma: float = 0.1
    lr: float = 0.05
    max_steps: int = 200

    def init(self, generator):
        """θ, the flat params of a fresh policy (on the policy's device)."""
        params = self.policy.init(generator)
        layout = FlatLayout.of(params)
        object.__setattr__(self, "layout", layout)
        return layout.ravel(params)

    def unravel(self, theta):
        return self.layout.unravel(theta)

    def fitness(self, thetas, generator=None, state=None):
        """(P,) episode returns of the (P, n) members."""
        return episode_return(self.policy, self.unravel(thetas), self.env,
                              generator, self.max_steps, state)

    def noise(self, generator, n_params):
        """The half population's perturbations ε, (pop_size / 2, n)."""
        return torch.randn((self.pop_size // 2, n_params),
                           generator=generator, device=generator.device)

    def step(self, theta, generator):
        """One generation, its draws from `generator`."""
        eps = self.noise(generator, theta.shape[0])
        return self.step_noise(theta, eps, common_start(
            self.env, generator, self.pop_size))

    def step_noise(self, theta, eps, start):
        """One generation from the half population's perturbations `eps`
        and the members' common start state `start` (a batch of
        pop_size). Returns (theta, mean_fitness, comm_bytes)."""
        eps = torch.cat([eps, -eps], dim=0)              # antithetic
        pop = theta[None] + self.sigma * eps
        fits = self.fitness(pop, state=start)
        shaped = centered_ranks(fits)
        grad = (shaped[:, None] * eps).mean(0) / self.sigma
        theta = theta + self.lr * grad
        # survey §7.1: inter-worker traffic = one f32 fitness per member
        comm_bytes = 4 * self.pop_size
        return theta, fits.mean(), comm_bytes
