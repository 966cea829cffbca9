"""Deep GA (Such et al. 2017; survey §7.2), the port of
src/repro/core/evo/ga.py: gradient-free truncation selection with the
compact seed-chain encoding. An individual is the list of mutation seeds
that rebuilds it, so workers exchange a few seeds instead of parameter
vectors.

The chains are small integer tensors on the host (a seed is read there
to seed its generator); each ε(seed) is drawn on the population's device
from a generator seeded with it, so one chain rebuilds one θ, bitwise,
on a device. Torch's generators do not give JAX's threefry bits, so the
port's θ for a chain is its own; the selection and mutation step is the
reference's, and `step_noise` takes its draws as tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.evo.es import FlatLayout, top_k
from repro_torch.core.rollout import episode_return

SEED_HIGH = 2 ** 31 - 1   # new seeds in [1, SEED_HIGH), 0 = empty slot


@dataclasses.dataclass(frozen=True)
class DeepGA:
    policy: object
    env: object
    pop_size: int = 32
    truncation: int = 8
    sigma: float = 0.05
    max_steps: int = 200
    chain_len: int = 16           # max generations encoded per individual

    def init(self, generator):
        params = self.policy.init(generator)
        layout = FlatLayout.of(params)
        object.__setattr__(self, "layout", layout)
        object.__setattr__(self, "theta0", layout.ravel(params))
        # population = seed chains (pop, chain_len); 0 = empty slot
        return {"chains": torch.zeros((self.pop_size, self.chain_len),
                                      dtype=torch.int64),
                "lens": torch.zeros((self.pop_size,), dtype=torch.int64)}

    def seed_noise(self, seed):
        """ε(seed): standard normal (n,) on θ0's device from a generator
        seeded with `seed`."""
        gen = torch.Generator(device=self.theta0.device).manual_seed(
            int(seed))
        return torch.randn(self.theta0.shape, generator=gen,
                           device=self.theta0.device)

    def reconstruct(self, chains, lens):
        """θ = θ0 + σ Σ_{i < len} ε(seed_i) for each chain: (P, n) from
        (P, chain_len) chains and (P,) lengths (host tensors)."""
        thetas = []
        for chain, n in zip(chains.tolist(), lens.tolist()):
            theta = self.theta0
            for seed in chain[:n]:
                theta = theta + self.sigma * self.seed_noise(seed)
            thetas.append(theta)
        return torch.stack(thetas)

    def fitness(self, state, generator=None, start=None):
        """(P,) episode returns of the population, each member its own
        episode (from `start` or fresh resets)."""
        thetas = self.reconstruct(state["chains"], state["lens"])
        return episode_return(self.policy, self.layout.unravel(thetas),
                              self.env, generator, self.max_steps, start)

    def draws(self, generator):
        """(parent slots (P,) in [0, truncation), new seeds (P,)), host
        tensors."""
        slots = torch.randint(0, self.truncation, (self.pop_size,),
                              generator=generator, device=generator.device)
        seeds = torch.randint(1, SEED_HIGH, (self.pop_size,),
                              generator=generator, device=generator.device)
        return slots.cpu(), seeds.cpu()

    def step(self, state, generator):
        """One generation, its draws and resets from `generator`."""
        fits = self.fitness(state, generator)
        return self.step_noise(state, fits, *self.draws(generator))

    def step_noise(self, state, fits, slots, seeds):
        """Truncation selection and seed-append mutation from the
        generation's fitnesses and its draws: child i takes the parent
        top[slots[i]] among the `truncation` best and appends seeds[i];
        slot 0 keeps the best unmutated. Returns (state, best_fitness,
        comm_bytes)."""
        top = top_k(fits.cpu(), self.truncation)
        parents = top[slots]
        pc, pl = state["chains"][parents], state["lens"][parents]
        pos = torch.clamp(pl, max=self.chain_len - 1)
        chains = pc.clone()
        chains[torch.arange(self.pop_size), pos] = seeds.to(torch.int64)
        lens = torch.clamp(pl + 1, max=self.chain_len)
        # elitism: slot 0 keeps the best individual unmutated
        best = top[0]
        chains[0] = state["chains"][best]
        lens[0] = state["lens"][best]
        # survey §7.2: traffic = one uint32 seed + one f32 fitness each
        comm_bytes = 8 * self.pop_size
        return {"chains": chains, "lens": lens}, fits.max(), comm_bytes
