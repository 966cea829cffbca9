"""IMPALA with explicit policy-lag through the unified Trainer on the
registry-resolved CartPole (`envs.make("cartpole")`; the port of
examples/impala_pendulum.py) — reproduces the survey's §6.1 claim:
V-trace correction recovers performance lost to actor/learner policy
lag.

  PYTHONPATH=src python examples/repro_torch/impala_pendulum.py \
      [--device cpu]
"""
import argparse

import repro_torch.envs as envs
from repro_torch.core.trainer import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    device = ap.parse_args().device
    env = envs.make("cartpole")
    for lag in (0, 4):
        for vtrace in (True, False):
            cfg = TrainerConfig(
                algo="impala", iters=60, superstep=10, n_envs=32,
                unroll=32, policy_lag=lag, seed=0, log_every=60,
                algo_kwargs={"use_vtrace": vtrace})
            _, hist = Trainer(env, cfg, device=device).fit()
            print(f"lag={lag} vtrace={vtrace}: "
                  f"return={hist[-1]['episode_return']}")


if __name__ == "__main__":
    main()
