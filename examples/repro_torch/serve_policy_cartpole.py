"""Serve a trained policy from a checkpoint: the full production loop
(the port of examples/serve_policy_cartpole.py).

  PYTHONPATH=src python examples/repro_torch/serve_policy_cartpole.py \
      [--device cpu]

Train PPO on CartPole for a few iterations, save the TrainState with
repro_torch.checkpoint (the reference's Trainer archive layout), restore
it into a fresh ParamStore (`load_checkpoint` republishes the
actor-policy view bitwise), then replay a small open-loop offered load
through the bucketed micro-batching engine and report p50/p99 latency —
with a live hot-swap halfway through to show the program count staying
flat.

For the real benchmark grid (multiple offered loads x bucket
configurations -> BENCH_torch_serve.json) use the launcher:

  PYTHONPATH=src python -m repro_torch.launch.serve_policy --algo ppo \
      --quick
"""
import argparse
import os
import tempfile

import torch

import repro_torch.envs as envs
from repro_torch.checkpoint import save_train_state
from repro_torch.core.serving import ParamStore, ServeEngine
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.launch.serve_policy import run_offered_load


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    device = ap.parse_args().device

    # ---- train + checkpoint ------------------------------------------------
    env = envs.make("cartpole")
    cfg = TrainerConfig(algo="ppo", iters=12, superstep=4, n_envs=8,
                        unroll=16, seed=0, log_every=4)
    trainer = Trainer(env, cfg, device=device)
    state, hist = trainer.fit()
    path = save_train_state(
        os.path.join(tempfile.mkdtemp(), "ppo_cartpole.npz"), state)
    print("trained:", hist[-1], "->", path)

    # ---- restore into a serving ParamStore ---------------------------------
    store = ParamStore()
    store.load_checkpoint(path, trainer.agent)
    engine = ServeEngine.for_agent(trainer.agent, env, buckets=(4, 16),
                                   store=store, seed=7, device=device)
    print("warmup compiles:", engine.warmup())   # one per bucket

    # ---- a mini offered-load replay (400 requests/second) ------------------
    obs_rows = env.spec.observation.sample(torch.Generator().manual_seed(1),
                                           64).numpy()
    _, params = store.get()
    swap = {k: v * (1 + 1e-3) for k, v in params.items()}
    cell = run_offered_load(engine, obs_rows, load_rps=400, n=200,
                            swap_params=swap)
    print(f"served {cell['n']} requests @ {cell['offered_rps']:g} rps: "
          f"p50={cell['p50_ms']:.2f}ms p99={cell['p99_ms']:.2f}ms "
          f"throughput={cell['throughput_rps']:.0f} rps "
          f"versions_served={cell['versions']}")
    print("engine stats:", engine.stats,
          "compiles:", engine.compile_count)   # still == warmup count
    assert engine.compile_count == len(engine.buckets)


if __name__ == "__main__":
    main()
