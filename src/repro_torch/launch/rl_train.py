"""DRL launcher: config parsing + ``Trainer.fit`` on one device (the
port of src/repro/launch/rl_train.py).

  PYTHONPATH=src python -m repro_torch.launch.rl_train --algo impala \\
      --env cartpole --plan "hosts=2:allreduce:bsp,workers=2:gossip:asp"

  --algo      a3c | dqn | impala | ppo    (Agent registry)
  --env       a registered environment    (repro_torch.envs)
  --policy    mlp | trunk                 the policy network
  --plan      a DistPlan, comma-separated axes outermost first, each
              ``name=size[:collective[:sync[:role]]]`` (the reference's
              grammar): collective in {ps, allreduce, gossip} (§3), sync
              in {bsp, asp, ssp} (§6), role ``data``, ``shard``
              (ZeRO-2), ``zero3`` (ZeRO-3) or ``replay`` (the sharded
              replay service, DQN)
  --actors    elastic env-shard schedule, e.g. ``16,32``: the total env
              count cycles through these values per superstep
  --device    the torch device (default: the card; raises without one)
  --trace-out PATH  profile the last superstep: its Chrome trace to PATH,
              the program's counters beside it (PATH less `.json`, plus
              `.counters.json`; repro_torch.tracing)

The legacy single-axis flags (``--n-workers``, ``--topology``,
``--sync``, ``--max-delay``, ``--staleness-bound``) lower onto
``DistPlan.flat``. Every data position of the plan (``--n-workers 4``:
four) runs on the one device, one thread each, meeting at the plan's
collectives (core/positions.py). Training runs as supersteps:
``--superstep K`` iterations of rollout -> learner_step -> lag-ring push
per dispatch, with the metrics read back once per dispatch;
``--unfused`` reads them back every iteration (the same numbers,
bitwise). ``--pipeline`` splits each iteration into a rollout producer
and a learner consumer joined by a trajectory queue as deep as the
plan's sync disciplines admit (``--sync ssp --staleness-bound 1``: one).
Prints one JSON line, the reference's, plus the device.

``--backend gloo|nccl`` runs each data position in a process of its own
instead (core/positions.py, "Processes"): this command spawns the plan's
``sim_devices`` processes, one rank each of a ``torch.distributed`` group,
and rank 0's line is printed with ``backend`` and ``n_processes`` added;
the fit is bitwise the threaded one. ``nccl`` puts rank r on ``cuda:r``
and refuses, before it spawns, a plan with more ranks than cards;
``gloo`` puts every rank on ``--device`` (on one card, all share it) and
moves the collectives through the host. A rank that fails makes the
command fail, naming the rank; no process outlives it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

ALGOS = ("a3c", "dqn", "impala", "ppo")
TOPOLOGY_CHOICES = ("allreduce", "ps", "gossip")
SYNC_CHOICES = ("bsp", "asp", "ssp")
BACKENDS = ("positions", "gloo", "nccl")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.rl_train",
        description="DRL launcher on one device (PyTorch port).")
    ap.add_argument("--algo", default="impala", choices=ALGOS)
    ap.add_argument("--env", default="cartpole", metavar="ENV",
                    help="registered environment (repro_torch.envs)")
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--superstep", type=int, default=10,
                    help="iterations per dispatch")
    ap.add_argument("--n-envs", type=int, default=32)
    ap.add_argument("--unroll", type=int, default=32)
    ap.add_argument("--plan", default=None, metavar="PLAN",
                    help="hierarchical DistPlan, e.g. 'hosts=2:allreduce:"
                         "bsp,workers=2:gossip:asp' or 'workers=2:"
                         "allreduce:bsp,replay=2:allreduce:bsp:replay'; "
                         "overrides --n-workers/--topology/--sync")
    ap.add_argument("--actors", default=None, metavar="N,N,...",
                    help="elastic env-shard schedule: total env counts "
                         "cycled per superstep (each must divide across "
                         "the plan's data positions)")
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
                    help="decoupled actor-learner pipeline: a trajectory "
                         "queue as deep as the plan's sync admits")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace of the last superstep to "
                         "PATH and the program's counters beside it")
    ap.add_argument("--backend", default="positions", choices=BACKENDS,
                    help="positions: every data position a thread on "
                         "--device; gloo, nccl: a process each, over "
                         "torch.distributed (nccl: a card a rank)")
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


@dataclasses.dataclass
class ProcessRun:
    """What `main` returns in the Trainer's place under a process
    backend: every rank's kernel launch counts and seconds in its
    Trainer (construction and fit, the line's `wall_s` unrounded), rank
    0's `Trainer.superstep_s` and its line."""
    backend: str
    n_processes: int
    launches: list       # each rank's {kernel wrapper name: launches}
    fit_s: list
    superstep_s: list
    line: dict


def _config(args, plan):
    from repro_torch.core.trainer import TrainerConfig
    algo_kwargs = {"policy": args.policy}
    if args.algo == "impala":
        algo_kwargs["use_vtrace"] = not args.no_vtrace
    return TrainerConfig(
        algo=args.algo, iters=args.iters, superstep=args.superstep,
        n_envs=args.n_envs, unroll=args.unroll, plan=plan,
        policy_lag=args.policy_lag, seed=args.seed,
        log_every=args.log_every, pipeline=args.pipeline,
        algo_kwargs=algo_kwargs)


def _line(args, plan, trainer, t0, history):
    return {
        "algo": args.algo, "env": args.env, "policy": args.policy,
        # the reference's keys: the plan and its device count (every
        # position, replay members included, shares this one device)
        "plan": plan.describe(), "n_devices": plan.n_devices,
        "fused": not args.unfused, "pipeline": args.pipeline,
        "pipeline_depth": trainer.pipeline_depth,
        "pipeline_capacity": trainer.pipeline_capacity,
        "actor_shards": trainer.actor_shards[-5:],
        # the shard axis's geometry (ZeRO); None without one larger than 1
        "partition": trainer.partition,
        # the sharded replay service: axis, shard count, global and
        # per-shard slots; None without a replay axis larger than 1
        "partition_replay": trainer.partition_replay,
        "device": str(trainer.device),
        "wall_s": round(time.time() - t0, 1), "history": history[-5:]}


def _rank_fit(group, args):
    """One rank's process: its data position's fit. Returns its kernel
    launches and, from rank 0, the line, history and final state (on the
    host)."""
    import repro_torch.envs as envs
    from repro_torch import kernels
    from repro_torch.core.trainer import Trainer, state_to
    plan = plan_of(args)
    t0 = time.time()
    trainer = Trainer(envs.make(args.env), _config(args, plan),
                      device=group.device, positions=group)
    state, history = trainer.fit(
        fused=not args.unfused,
        trace_out=args.trace_out if group.rank == 0 else None)
    out = {"launches": kernels.launch_counts(), "fit_s": time.time() - t0}
    if group.rank == 0:
        out.update(line=_line(args, plan, trainer, t0, history),
                   history=history, state=state_to(state, "cpu"),
                   superstep_s=trainer.superstep_s)
    return out


def _launch(ap, args, plan):
    """The process backends: check what can be checked here, spawn a
    process a data position, print rank 0's line."""
    import torch
    import repro_torch.envs as envs
    from repro_torch.core.positions import run_processes
    from repro_torch.core.trainer import Trainer, state_to
    from repro_torch.kernels.common import resolve_device
    n = plan.sim_devices
    if args.backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if cards < n:
            ap.error(f"--backend nccl runs a rank a card: {n} ranks, "
                     f"{cards} card{'' if cards == 1 else 's'}")
        devices = [f"cuda:{r}" for r in range(n)]
    else:
        devices = [args.device] * n
    resolve_device(devices[0])
    try:   # the Trainer's own checks, before any process starts
        Trainer(envs.make(args.env), _config(args, plan), device="cpu")
    except ValueError as e:
        ap.error(str(e))
    # each rank at this process's intra-op thread count: the CPU's
    # reductions may depend on it, and a fit is bitwise the threaded one
    results = run_processes(
        _rank_fit, (args,), n=n, backend=args.backend, devices=devices,
        threads=torch.get_num_threads())
    line = dict(results[0]["line"], backend=args.backend, n_processes=n)
    print(json.dumps(line))
    run = ProcessRun(args.backend, n, [r["launches"] for r in results],
                     [r["fit_s"] for r in results],
                     results[0]["superstep_s"], line)
    return (run, state_to(results[0]["state"], devices[0]),
            results[0]["history"])


def main(argv=None):
    """Parse `argv`, train, print the JSON line; returns (trainer, final
    TrainState, full history) for callers that drive it in-process
    (under a process backend a `ProcessRun` in the trainer's place, and
    position 0's state on the first rank's device)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        plan = plan_of(args)
    except ValueError as e:
        ap.error(str(e))

    import repro_torch.envs as envs
    from repro_torch.core.trainer import Trainer

    if args.env not in envs.available():
        ap.error(f"--env {args.env} not registered in the port; available: "
                 f"{envs.available()}")
    if args.backend != "positions":
        return _launch(ap, args, plan)
    t0 = time.time()
    try:
        trainer = Trainer(envs.make(args.env), _config(args, plan),
                          device=args.device)
    except ValueError as e:  # e.g. a replay axis on an algorithm without
        ap.error(str(e))     # a prioritized buffer, n_envs that does not
        #                      divide across the positions, or --pipeline
        #                      with a zero3 or replay axis
    state, history = trainer.fit(fused=not args.unfused,
                                 trace_out=args.trace_out)
    print(json.dumps(_line(args, plan, trainer, t0, history)))
    return trainer, state, history


if __name__ == "__main__":
    main()
