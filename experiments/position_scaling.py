"""What a fit costs on the card as its plan's data positions grow: `rl_train
--algo A --n-workers W` on cartpole (32 envs split W ways, 32 steps, MLP
(64, 64)) for W = 1, 2 and 4, every position on the one card.

    PYTHONPATH=src python experiments/position_scaling.py [--iters 20]

Per algorithm one fit warms up (the kernel build, the allocator,
cuBLAS); then, for each W, FITS fits are timed on the host clock, each
ending in a sync (ms per iteration, env steps a second), and for impala
one more fit runs under torch.profiler (`launch/profiling.device_window`):
its device time and device operations per iteration and the card's busy
share, which say how much of an iteration is the host issuing ops.
Prints one JSON line per (algorithm, W) beside the card's name and power
limit. Needs a card.
"""
import argparse
import contextlib
import io
import json
import time

import torch

ALGOS = ("impala", "ppo", "a3c")
POSITIONS = (1, 2, 4)
FITS = 2


def fit(algo, W, iters):
    """One `rl_train` fit; returns (its iterations, env steps each)."""
    from repro_torch.launch.rl_train import main as rl_main
    with contextlib.redirect_stdout(io.StringIO()):
        trainer, _, _ = rl_main(["--algo", algo, "--env", "cartpole",
                                 "--n-workers", str(W), "--iters",
                                 str(iters)])
    cfg = trainer.cfg
    return cfg.iters, cfg.n_envs * cfg.unroll


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("position_scaling measures the card; torch sees "
                           "no CUDA device")
    from repro_torch.launch.profiling import card, device_window
    for algo in ALGOS:
        fit(algo, 1, args.iters)
        for W in POSITIONS:
            ms = []
            for _ in range(FITS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                iters, steps = fit(algo, W, args.iters)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3 / iters)
            row = {"card": card(), "algo": algo, "W": W, "iters": iters,
                   "ms_per_iter": ms,
                   "env_steps_per_s": [steps * 1e3 / m for m in ms]}
            if algo == "impala":
                window = device_window(lambda: fit(algo, W, args.iters), 1)
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
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
