"""What the default IMPALA fit costs on the card, and how many device
operations an iteration issues: `rl_train --algo impala --env cartpole`
(the default config: 60 iterations of 32 envs x 32 steps) in one
process.

    PYTHONPATH=src python experiments/impala_fit_cost.py

One fit warms up (the kernel build, the allocator, cuBLAS); then FITS
fits are timed on the host clock, each ending in a sync (ms per
iteration); then one fit runs under torch.profiler
(`launch/profiling.device_window`): its device operations and device
time per iteration, the card's busy share, and `vtrace_tb`'s launches
per iteration. Prints one JSON line beside the card's name and power
limit. It calls only the package's entry points, so an older checkout is
measured the same way with `PYTHONPATH=<that checkout>/src`. Needs a
card.
"""
import contextlib
import io
import json
import time

import torch

ARGV = ["--algo", "impala", "--env", "cartpole"]
FITS = 2


def fit():
    """One `rl_train` fit; returns its iterations."""
    from repro_torch.launch.rl_train import main as rl_main
    with contextlib.redirect_stdout(io.StringIO()):
        trainer, _, _ = rl_main(ARGV)
    return trainer.cfg.iters


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("impala_fit_cost measures the card; torch sees "
                           "no CUDA device")
    from repro_torch.kernels.vtrace.kernel import vtrace_tb
    from repro_torch.launch.profiling import card, device_window
    iters = fit()
    ms = []
    for _ in range(FITS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / iters)
    vtrace_tb.launches = 0
    window = device_window(fit, 1)
    per_iter = {k: (window[k] / iters if window[k] is not None else None)
                for k in ("wall_ms", "device_ms_per_call",
                          "device_ops_per_call")}
    print(json.dumps({
        "card": card(), "argv": ARGV, "iters": iters,
        "ms_per_iter": ms, "profiled": {
            "wall_ms_per_iter": per_iter["wall_ms"],
            "device_ms_per_iter": per_iter["device_ms_per_call"],
            "device_ops_per_iter": per_iter["device_ops_per_call"],
            "device_busy_share": window["device_busy_share"],
            "records_whole": window["records_whole"],
            "vtrace_tb_launches_per_iter": vtrace_tb.launches / iters,
            "top_device_us_per_iter": [
                {"name": t["name"], "us": t["us"] / iters}
                for t in window["top_device_us_per_call"] or []]}}))


if __name__ == "__main__":
    main()
