"""What the pipelined mode and ZeRO-2/3 cost on the card against the
fits they equal or stand beside, fits timed in turns so that neither side
of a pair always runs first:

  * impala at the default config (32 envs, 32 steps, MLP (64, 64)), one
    position: fused bsp, fused `--sync ssp --staleness-bound 1`, and the
    pipelined `--sync ssp --staleness-bound 1 --pipeline` (depth 1);
  * impala at 4 positions: flat(4), `workers=2 x shard=2` (ZeRO-2) and
    `workers=2 x zero3=2` (ZeRO-3), bitwise equal fits;
  * the full-width trunk (4 layers, d_model 256) under impala at 2
    positions: flat(2), zero(1, 2) and zero3(1, 2) (layer-wise).

    PYTHONPATH=src python experiments/pipeline_zero_cost.py [--iters 20]

Per group one fit of its first variant warms up (the kernel build, the
allocator, cuBLAS); then every variant is timed ROUNDS times in the order
A B C, C B A, ... on the host clock, each fit ending in a sync (ms per
iteration, env steps a second), and, for the MLP groups, one more fit of
each runs under torch.profiler (`launch/profiling.device_window`): device
ms and device operations an iteration and the card's busy share. Prints
one JSON line per group beside the card's name and power limit. Needs a
card.
"""
import argparse
import contextlib
import io
import json
import time

import torch

ROUNDS = 2
TRUNK_ITERS = 3


def cli(argv):
    """An `rl_train` fit as a function of nothing; returns its trainer."""
    def run():
        from repro_torch.launch.rl_train import main as rl_main
        with contextlib.redirect_stdout(io.StringIO()):
            trainer, _, _ = rl_main(argv)
        return trainer
    return run


def trunk(plan):
    """A full-width trunk impala fit under `plan` (Trainer: rl_train's
    --policy trunk is the reduced trunk)."""
    def run():
        import repro_torch.envs as envs
        from repro_torch.core.trainer import Trainer, TrainerConfig
        cfg = TrainerConfig(algo="impala", iters=TRUNK_ITERS,
                            superstep=TRUNK_ITERS, plan=plan,
                            algo_kwargs={"policy": "trunk", "trunk_kwargs": {
                                "reduced": False}})
        trainer = Trainer(envs.make("cartpole"), cfg)
        trainer.fit()
        return trainer
    return run


def timed(run):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = run()
    torch.cuda.synchronize()
    return trainer, (time.perf_counter() - t0) * 1e3


def group(name, variants, profile):
    from repro_torch.launch.profiling import card, device_window
    labels = list(variants)
    timed(variants[labels[0]])                       # warm up
    ms = {label: [] for label in labels}
    rows = {}
    for r in range(ROUNDS):
        for label in (labels if r % 2 == 0 else labels[::-1]):
            trainer, wall = timed(variants[label])
            cfg = trainer.cfg
            ms[label].append(wall / cfg.iters)
            rows[label] = {
                "plan": trainer.plan.describe(), "W": trainer.n_positions,
                "pipeline_depth": trainer.pipeline_depth,
                "partition": trainer.partition, "iters": cfg.iters,
                "state_bytes": trainer.state_bytes,
                "steps_per_iter": cfg.n_envs * cfg.unroll}
    for label in labels:
        row = rows[label]
        row["ms_per_iter"] = ms[label]
        row["env_steps_per_s"] = [row["steps_per_iter"] * 1e3 / m
                                  for m in ms[label]]
        if profile:
            window = device_window(variants[label], 1)
            iters = row["iters"]
            row["profiled"] = {
                "wall_ms_per_iter": window["wall_ms"] / iters,
                "device_ms_per_iter": (
                    None if window["device_ms_per_call"] is None
                    else window["device_ms_per_call"] / iters),
                "device_ops_per_iter": (
                    None if window["device_ops_per_call"] is None
                    else window["device_ops_per_call"] / iters),
                "device_busy_share": window["device_busy_share"],
                "records_whole": window["records_whole"]}
    print(json.dumps({"group": name, "card": card(), "rounds": ROUNDS,
                      "variants": rows}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("pipeline_zero_cost measures the card; torch "
                           "sees no CUDA device")
    from repro_torch.core.distribution import DistPlan
    base = ["--algo", "impala", "--env", "cartpole", "--iters",
            str(args.iters)]
    ssp = ["--sync", "ssp", "--staleness-bound", "1"]
    group("impala-pipeline", {
        "fused": cli(base), "fused-ssp1": cli(base + ssp),
        "pipeline-ssp1": cli(base + ssp + ["--pipeline"])}, True)
    spec = "workers=2:allreduce:bsp,shard=2:allreduce:bsp:{}"
    group("impala-zero-w4", {
        "flat4": cli(base + ["--n-workers", "4"]),
        "zero2-2x2": cli(base + ["--plan", spec.format("shard")]),
        "zero3-2x2": cli(base + ["--plan", spec.format("zero3")])}, True)
    group("impala-trunk-full-w2", {
        "flat2": trunk(DistPlan.flat(2)),
        "zero2-1x2": trunk(DistPlan.zero(1, 2)),
        "zero3-1x2": trunk(DistPlan.zero3(1, 2))}, False)


if __name__ == "__main__":
    main()
