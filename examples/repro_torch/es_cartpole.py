"""Evolution-based training (survey §7; the port of
examples/es_cartpole.py): ES and Deep-GA on the registry-resolved
CartPole (`envs.make("cartpole")`), reporting the per-generation
communication bytes that make evolutionary methods massively
parallelizable — then a gradient-based baseline driven by the unified
Trainer under an explicit `DistPlan` (declared mesh, collective, sync
and elastic actor shards) for the comparison.

  PYTHONPATH=src python examples/repro_torch/es_cartpole.py [--device cpu]
"""
import argparse

import torch

import repro_torch.envs as envs
from repro_torch.core.distribution import DistPlan
from repro_torch.core.evo import ES, DeepGA
from repro_torch.core.networks import MLPPolicy
from repro_torch.core.trainer import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    device = ap.parse_args().device
    env = envs.make("cartpole")
    pol = MLPPolicy.for_spec(env.spec, hidden=(16,), device=device)
    n_params = sum(x.numel() for x in
                   pol.init(torch.Generator().manual_seed(0)).values())

    es = ES(pol, env, pop_size=32, sigma=0.3, lr=0.2, max_steps=200)
    theta = es.init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)
    for g in range(10):
        theta, fit, comm = es.step(theta, gen)
        print(f"ES gen {g}: mean_fitness={float(fit):.1f} "
              f"comm={comm}B (grad exchange would be {4 * n_params}B)")

    ga = DeepGA(pol, env, pop_size=32, truncation=8, sigma=0.3,
                max_steps=200)
    state = ga.init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(2)
    for g in range(10):
        state, best, comm = ga.step(state, gen)
        print(f"GA gen {g}: best_fitness={float(best):.1f} comm={comm}B "
              f"(seed-chain encoding)")

    # gradient-based baseline under an explicit DistPlan: the 1-D mesh,
    # collective and sync are declared (not hard-coded flags), and the
    # elastic actors= schedule cycles the env-shard count 16 -> 32
    # between supersteps — gradient exchange moves 4*n_params bytes per
    # step where ES moved `comm`
    plan = DistPlan.flat(1, collective="allreduce", sync="bsp",
                         actors=(16, 32))
    cfg = TrainerConfig(algo="a3c", iters=20, superstep=5, n_envs=16,
                        unroll=32, plan=plan, log_every=10)
    trainer = Trainer(env, cfg, device=device)
    _, hist = trainer.fit()
    print(f"A3C baseline under plan {plan.describe()}: "
          f"{hist[-1]} actor_shards={trainer.actor_shards} "
          f"(grad exchange: {4 * n_params}B/step)")


if __name__ == "__main__":
    main()
