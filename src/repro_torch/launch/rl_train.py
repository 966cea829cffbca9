"""DRL launcher on one device: config parsing + ``Trainer.fit`` (the port
of src/repro/launch/rl_train.py for the plans that fit one device).

  PYTHONPATH=src python -m repro_torch.launch.rl_train --algo dqn \\
      --env cartpole --plan "workers=1:allreduce:bsp,replay=2:allreduce:bsp:replay"

  --algo      a3c | dqn | impala | ppo    (Agent registry)
  --env       a registered environment    (repro_torch.envs)
  --policy    mlp | trunk                 the policy network
  --plan      a DistPlan, comma-separated axes outermost first, each
              ``name=size[:collective[:sync[:role]]]`` (the reference's
              grammar); runs with one data position: data axes of size
              1 with any sync, and a ``replay`` axis (the sharded replay
              service, DQN) of any size
  --device    the torch device (default: the card; raises without one)

The legacy single-axis flags (``--n-workers``, ``--topology``,
``--sync``, ``--max-delay``, ``--staleness-bound``) lower onto
``DistPlan.flat``, so ``--sync asp`` trains one worker under the asp
delay schedule. Training runs as supersteps: ``--superstep K``
iterations of rollout -> learner_step -> lag-ring push per dispatch,
with the metrics read back once per dispatch; ``--unfused`` reads them
back every iteration (the same numbers, bitwise). Plans that need more
than one data position, shard/zero3 axes, an elastic ``--actors``
schedule and ``--pipeline`` are refused with the slice that ports them.
Prints one JSON line, the reference's, plus the device.
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
                    help="hierarchical DistPlan, e.g. 'workers=1:allreduce:"
                         "bsp,replay=2:allreduce:bsp:replay'")
    ap.add_argument("--actors", default=None, metavar="N,N,...",
                    help="elastic env-shard schedule (an elastic one comes "
                         "with the distribution slice)")
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


def plan_of(args):
    """The DistPlan the flags ask for: --plan, else the legacy flags
    lowered onto the 1-D plan."""
    from repro_torch.core.distribution import DistPlan
    actors = (tuple(int(n) for n in args.actors.split(","))
              if args.actors else None)
    if args.plan is not None:
        return DistPlan.parse(args.plan, max_delay=args.max_delay,
                              staleness_bound=args.staleness_bound,
                              actors=actors)
    return DistPlan.flat(args.n_workers, args.topology, args.sync,
                         args.max_delay, args.staleness_bound, actors=actors)


def refusal(args, plan):
    """The message refusing what this port does not run yet, naming the
    flag and the slice that ports it, or None."""
    from repro_torch.core.trainer import plan_refusal
    if args.pipeline:
        return ("--pipeline is not ported yet: it comes with the pipeline "
                "slice (ROADMAP queue 1, item 11)")
    msg = plan_refusal(plan, args.n_envs)
    if msg is None:
        return None
    if msg.startswith("actors="):
        flag = f"--actors {args.actors}"
    elif args.plan is not None:
        flag = f"--plan {args.plan}"
    else:
        flag = (f"--n-workers {args.n_workers} (the plan "
                f"{plan.describe()})")
    return f"{flag}: {msg}"


def main(argv=None):
    """Parse `argv`, train, print the JSON line; returns (trainer, final
    TrainState, full history) for callers that drive it in-process."""
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        plan = plan_of(args)
    except ValueError as e:
        ap.error(str(e))
    msg = refusal(args, plan)
    if msg is not None:
        ap.error(msg)

    import repro_torch.envs as envs
    from repro_torch.core.trainer import Trainer, TrainerConfig

    if args.env not in envs.available():
        ap.error(f"--env {args.env} not registered in the port; available: "
                 f"{envs.available()}")
    algo_kwargs = {"policy": args.policy}
    if args.algo == "impala":
        algo_kwargs["use_vtrace"] = not args.no_vtrace
    cfg = TrainerConfig(
        algo=args.algo, iters=args.iters, superstep=args.superstep,
        n_envs=args.n_envs, unroll=args.unroll, plan=plan,
        policy_lag=args.policy_lag, seed=args.seed,
        log_every=args.log_every, algo_kwargs=algo_kwargs)
    env = envs.make(args.env)
    t0 = time.time()
    try:
        trainer = Trainer(env, cfg, device=args.device)
    except ValueError as e:  # e.g. a replay axis on an algorithm without
        ap.error(str(e))     # a prioritized buffer
    state, history = trainer.fit(fused=not args.unfused)
    print(json.dumps({
        "algo": args.algo, "env": args.env, "policy": args.policy,
        # the reference's keys: the plan and its device count (a replay
        # group's members share this one device)
        "plan": plan.describe(), "n_devices": plan.n_devices,
        "fused": not args.unfused, "pipeline": False,
        "pipeline_depth": 0, "pipeline_capacity": None,
        "actor_shards": trainer.actor_shards[-5:],
        "partition": None,
        # the sharded replay service: axis, shard count, global and
        # per-shard slots; None without a replay axis larger than 1
        "partition_replay": trainer.partition_replay,
        "device": str(trainer.device),
        "wall_s": round(time.time() - t0, 1), "history": history[-5:]}))
    return trainer, state, history


if __name__ == "__main__":
    main()
