"""Quickstart: the PyTorch port in ~80 lines (the port of
examples/quickstart.py).

  PYTHONPATH=src python examples/repro_torch/quickstart.py   # the card
  PYTHONPATH=src python examples/repro_torch/quickstart.py --device cpu

1. Train a reduced assigned-architecture LM for a few steps.
2. Serve it with a KV cache.
3. Run distributed DRL (IMPALA + V-trace) on CartPole, resolved through
   the env registry (`envs.make("cartpole")`) — then the same run
   pipelined: rollout producer and learner consumer decoupled by a
   device-resident trajectory queue.
4. Serve the trained policy: bucketed micro-batching + versioned
   zero-recompile hot-swap through repro_torch.core.serving (see
   examples/repro_torch/serve_policy_cartpole.py for the
   checkpoint-restore and offered-load version).
5. Run an ES generation (evolution-based training, survey §7) with the
   policy built from the env's spec (`MLPPolicy.for_spec`).
"""
import argparse

import torch

import repro_torch.envs as envs
from repro_torch.core.distribution import DistPlan
from repro_torch.core.evo import ES
from repro_torch.core.networks import MLPPolicy
from repro_torch.core.serving import ServeEngine
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    device = ap.parse_args().device

    # ---- 1. LM training (learner path) -----------------------------------
    out = train("gemma3-1b", reduced=True, steps=30, batch=8, seq=64,
                lr=1e-3, log_every=10, device=device)
    print("train:", out["history"][-1], "optimal_ce:", out["optimal_ce"])

    # ---- 2. Serving (actor path) ------------------------------------------
    print("serve:", serve("gemma3-1b", reduced=True, batch=2,
                          prompt_len=16, gen_len=8, device=device))

    # ---- 3. Distributed DRL: IMPALA through the unified Trainer ------------
    env = envs.make("cartpole")      # name registry, parallel to agent.make
    # The distribution is declared, not hard-coded: a DistPlan names the
    # mesh axes (1-D here), the per-axis collective + sync discipline,
    # and an elastic actor-shard schedule — env shards cycle 16 -> 32
    # between supersteps while the agent only ever sees `traj`.
    plan = DistPlan.flat(1, collective="allreduce", sync="bsp",
                         actors=(16, 32))
    cfg = TrainerConfig(algo="impala", iters=40, superstep=10, n_envs=16,
                        unroll=16, plan=plan, policy_lag=2, log_every=10)
    trainer = Trainer(env, cfg, device=device)
    state, hist = trainer.fit()
    print("impala:", hist[-1], "plan:", plan.describe(),
          "actor_shards:", trainer.actor_shards)

    # ---- 3b. The same run, pipelined --------------------------------------
    # pipeline=True decouples each iteration into a rollout producer and a
    # learner consumer joined by a trajectory queue on the device. The
    # queue depth is whatever staleness the plan's sync discipline admits:
    # this ssp plan lets the producer run 1 iteration ahead of the
    # learner; a bsp plan would pin depth 0 (lockstep — bitwise identical
    # to the fused run above).
    pplan = DistPlan.flat(1, collective="allreduce", sync="ssp",
                          staleness_bound=1, max_delay=1)
    pcfg = TrainerConfig(algo="impala", iters=40, superstep=10, n_envs=16,
                         unroll=16, plan=pplan, log_every=10, pipeline=True)
    ptrainer = Trainer(env, pcfg, device=device)
    _, phist = ptrainer.fit()
    print("impala/pipelined:", phist[-1],
          f"depth={ptrainer.pipeline_depth}",
          f"queue_capacity={ptrainer.pipeline_capacity}")

    # ---- 4. Serve the trained policy --------------------------------------
    # The traffic-facing mirror of the Trainer: publish the live
    # actor-policy view into a versioned ParamStore, build one program per
    # bucket size up front, and serve micro-batches padded to the
    # smallest fitting bucket. Hot-swapping fresh params builds nothing
    # (params are inputs), pinned by compile_count.
    engine = ServeEngine.for_agent(trainer.agent, env, buckets=(1, 4, 16),
                                   device=device)
    engine.store.publish_from_state(trainer.agent, state)
    engine.warmup()                  # one program per bucket, up front
    obs = env.spec.observation.sample(torch.Generator().manual_seed(2),
                                      7).numpy()
    actions = engine.serve(obs)      # 7 requests -> bucket 16
    c0 = engine.compile_count
    engine.store.publish_from_state(trainer.agent, state)   # hot-swap
    engine.serve(obs)
    print("serve_policy:", f"actions={actions.tolist()}",
          f"version={engine.store.version}",
          f"compiles={engine.compile_count} (was {c0} before hot-swap)",
          f"stats={engine.stats}")
    assert engine.compile_count == c0    # the zero-recompile pin, live

    # ---- 5. Evolution strategies (survey §7) -------------------------------
    penv = envs.make("pendulum")
    ppol = MLPPolicy.for_spec(penv.spec, hidden=(16,), device=device)
    es = ES(ppol, penv, pop_size=16, max_steps=100)
    theta = es.init(torch.Generator().manual_seed(0))
    theta, fitness, comm = es.step(
        theta, torch.Generator(device=device).manual_seed(1))
    print(f"es: mean_fitness={float(fitness):.1f} comm_bytes={comm} "
          f"(vs {4 * theta.numel()} for a gradient exchange)")


if __name__ == "__main__":
    main()
