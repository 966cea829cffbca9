"""The torch.profiler window behind the port's per-layer device numbers
(`profile_serve`, `profile_lm`). Needs a card."""
from __future__ import annotations

import subprocess
import time

import torch


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def device_window(fn, n, share_of=None) -> dict:
    """Run `fn` n times under torch.profiler and report, per call: the
    device's busy share (device time over the window's host wall), device
    time, device ops and the ten kernels with the most device time.
    `share_of` maps a label to a kernel-name substring whose share of
    device time is reported as `<label>_share_of_device`."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    out = {"calls": n, "wall_ms": wall_us / 1e3,
           "device_busy_share": busy_us / wall_us if wall_us else None,
           "device_ms_per_call": busy_us / n / 1e3,
           "device_ops_per_call": len(kernels) / n}
    for label, part in (share_of or {}).items():
        us = sum(v for k, v in by_name.items() if part in k)
        out[f"{label}_share_of_device"] = us / busy_us if busy_us else 0.0
    out["top_device_us_per_call"] = [
        {"name": k[:80], "us": v / n}
        for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    return out
