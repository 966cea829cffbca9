"""Single-device DRL launcher: config parsing + ``Trainer.fit`` (the port
of src/repro/launch/rl_train.py without a distribution plan).

  PYTHONPATH=src python -m repro_torch.launch.rl_train --algo ppo \\
      --env cartpole --device cpu

  --algo      a3c | dqn | impala | ppo    (Agent registry)
  --env       a registered environment    (repro_torch.envs)
  --policy    mlp | trunk                 the policy network
  --device    the torch device (default: the card; raises without one)

Training runs as supersteps: ``--superstep K`` iterations of rollout ->
learner_step -> lag-ring push per dispatch, with the metrics read back
once per dispatch; ``--unfused`` reads them back every iteration (the
same numbers, bitwise). The flags of the reference's distributed modes
are parsed too, and refused with the slice that ports them. Prints one
JSON line, the reference's, plus the device.
"""
from __future__ import annotations

import argparse
import json
import time

ALGOS = ("a3c", "dqn", "impala", "ppo")
TOPOLOGY_CHOICES = ("allreduce", "ps", "gossip")
SYNC_CHOICES = ("bsp", "asp", "ssp")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.rl_train",
        description="Single-device DRL launcher (PyTorch port).")
    ap.add_argument("--algo", default="impala", choices=ALGOS)
    ap.add_argument("--env", default="cartpole", metavar="ENV",
                    help="registered environment (repro_torch.envs)")
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--superstep", type=int, default=10,
                    help="iterations per dispatch")
    ap.add_argument("--n-envs", type=int, default=32)
    ap.add_argument("--unroll", type=int, default=32)
    ap.add_argument("--plan", default=None, metavar="PLAN",
                    help="hierarchical DistPlan (the distribution slice)")
    ap.add_argument("--actors", default=None, metavar="N,N,...",
                    help="elastic env-shard schedule (the distribution "
                         "slice)")
    ap.add_argument("--policy", default="mlp", choices=("mlp", "trunk"),
                    help="policy network: the house actor-critic MLP or "
                         "the transformer trunk (paper-drl-trunk)")
    ap.add_argument("--n-workers", type=int, default=1)
    ap.add_argument("--topology", default="allreduce",
                    choices=TOPOLOGY_CHOICES)
    ap.add_argument("--sync", default="bsp", choices=SYNC_CHOICES)
    ap.add_argument("--policy-lag", type=int, default=0)
    ap.add_argument("--max-delay", type=int, default=4)
    ap.add_argument("--staleness-bound", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--no-vtrace", action="store_true",
                    help="impala only: naive targets instead of V-trace")
    ap.add_argument("--unfused", action="store_true",
                    help="read metrics back every iteration")
    ap.add_argument("--pipeline", action="store_true",
                    help="decoupled actor-learner pipeline (the pipeline "
                         "slice)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    return ap


def refusal(args):
    """The message refusing a flag this slice does not run, or None."""
    later = {
        "--plan": (args.plan is not None, "the distribution slice "
                                          "(ROADMAP queue 1, item 10)"),
        "--actors": (args.actors is not None, "the distribution slice "
                                              "(ROADMAP queue 1, item 10)"),
        "--pipeline": (args.pipeline, "the pipeline slice (ROADMAP queue "
                                      "1, item 11)"),
        "--n-workers > 1": (args.n_workers > 1, "the distribution slice "
                                                "(ROADMAP queue 1, item "
                                                "10)"),
        f"--sync {args.sync}": (args.sync != "bsp", "the sync slice "
                                                    "(core/sync.py delays, "
                                                    "ROADMAP queue 1, item "
                                                    "10)"),
    }
    for flag, (asked, slice_) in later.items():
        if asked:
            return f"{flag} is not ported yet: it comes with {slice_}"
    return None


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    msg = refusal(args)
    if msg is not None:
        ap.error(msg)

    import repro_torch.envs as envs
    from repro_torch.core.trainer import Trainer, TrainerConfig

    if args.env not in envs.available():
        ap.error(f"--env {args.env} not registered in the port; available: "
                 f"{envs.available()} (the -norm/-repeat wrappers come "
                 f"with the env-wrappers item, ROADMAP queue 1, item 2)")
    algo_kwargs = {"policy": args.policy}
    if args.algo == "impala":
        algo_kwargs["use_vtrace"] = not args.no_vtrace
    cfg = TrainerConfig(
        algo=args.algo, iters=args.iters, superstep=args.superstep,
        n_envs=args.n_envs, unroll=args.unroll, policy_lag=args.policy_lag,
        seed=args.seed, log_every=args.log_every, algo_kwargs=algo_kwargs)
    env = envs.make(args.env)
    t0 = time.time()
    trainer = Trainer(env, cfg, device=args.device)
    _, history = trainer.fit(fused=not args.unfused)
    print(json.dumps({
        "algo": args.algo, "env": args.env, "policy": args.policy,
        "plan": f"workers={args.n_workers}:{args.topology}:{args.sync}",
        "n_devices": 1, "fused": not args.unfused,
        "pipeline": False,
        "pipeline_depth": 0, "pipeline_capacity": None,
        "actor_shards": trainer.actor_shards[-5:],
        "partition": None, "partition_replay": None,
        "device": str(trainer.device),
        "wall_s": round(time.time() - t0, 1), "history": history[-5:]}))


if __name__ == "__main__":
    main()
