"""The torch.profiler windows behind the port's per-layer and per-kernel
device numbers (`profile_serve`, `profile_lm`, `profile_small_kernels`,
`chip_smoke.py`'s `device_us` and launch floors). Needs a card, but for
`records_whole`, the rule by which a window counts.

torch.profiler now and then loses kernel records (not the records of
their launch calls), late in a long process and sometimes in a short
one: a window whose kernel records fall short of its launch calls is run
again, and its numbers are None after a few tries."""
from __future__ import annotations

import subprocess
import time

import torch

TRIES = 5


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def records_whole(launch_calls, kernel_records, counts=None, calls=None):
    """Whether a profiler window kept every kernel record: it saw at least
    one kernel and no fewer kernel records than launch calls, and, where
    `counts` (records per kernel name) and `calls` (the calls of the
    window) are given, each kernel a whole number of times a call."""
    if kernel_records <= 0 or kernel_records < launch_calls:
        return False
    return counts is None or all(c % calls == 0 for c in counts.values())


def _is_launch(name: str) -> bool:
    return "Launch" in name and "Kernel" in name


def _is_copy(name: str) -> bool:
    return name.startswith(("Memset", "Memcpy"))


def _is_span(evt) -> bool:
    """A span's range on the device timeline (a `record_function`, such
    as the program's `repro_torch.*` spans): it covers kernels, it is
    none."""
    return bool(getattr(evt, "is_user_annotation", False))


def kernel_us(fn, calls=10, tries=TRIES):
    """Device time per call of each kernel `fn` launches, in us, from
    torch.profiler's key_averages (acc_events windows lost fewer records
    on the card), and each kernel's launches per call. A window that is
    not whole (`records_whole`, each kernel a whole number of times a
    call) is run again, up to `tries` windows; the times are None where
    none was whole, the launches the last window's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    launches = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times, counts, seen, launched = {}, {}, 0, 0
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                if _is_launch(evt.key):
                    launched += evt.count
                continue
            if _is_span(evt):
                continue
            t = getattr(evt, "self_device_time_total", None)
            times[evt.key[:60]] = (t if t is not None
                                   else evt.self_cuda_time_total) / calls
            counts[evt.key[:60]] = evt.count
            if not _is_copy(evt.key):
                seen += evt.count
        launches = {k: c / calls for k, c in counts.items()}
        if records_whole(launched, seen, counts, calls):
            return times, launches
    return None, launches


def beside_floor(fn, calls=10, tries=TRIES):
    """kernel_us of fn with the library's empty kernel
    (kernels/shared/csrc/null.cu) launched after each call in the same
    window: (fn's kernels' device us a call, the empty kernel's, the
    launch floor; fn's kernels' launches a call). None times where every
    window lost records."""
    from repro_torch.kernels.common import NULL_KERNEL, launch_null
    dev = torch.device("cuda", torch.cuda.current_device())
    times, launches = kernel_us(lambda: (fn(), launch_null(dev)), calls,
                                tries)
    launches = {k: c for k, c in launches.items() if NULL_KERNEL not in k}
    if times is None:
        return None, None, launches
    floor = sum(t for k, t in times.items() if NULL_KERNEL in k)
    return sum(times.values()) - floor, floor, launches


def device_window(fn, n, share_of=None, tries=TRIES) -> dict:
    """Run `fn` n times under torch.profiler and report, per call: the
    device's busy share (device time over the window's host wall), device
    time, device ops and the ten kernels with the most device time.
    `share_of` maps a label to a kernel-name substring whose share of
    device time is reported as `<label>_share_of_device`. A window whose
    kernel records fall short of its launch calls (`records_whole`) is
    run again, up to `tries` windows; after that every device number is
    None, and `records_whole` False."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - w0) * 1e6
        events = prof.events()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not _is_span(e)]
        launched = sum(1 for e in events
                       if e.device_type != torch.autograd.DeviceType.CUDA
                       and _is_launch(e.name))
        seen = sum(1 for e in kernels if not _is_copy(e.name))
        if records_whole(launched, seen):
            break
    else:
        return {"calls": n, "wall_ms": wall_us / 1e3, "records_whole": False,
                "device_busy_share": None, "device_ms_per_call": None,
                "device_ops_per_call": None, "top_device_us_per_call": None,
                **{f"{label}_share_of_device": None for label in share_of
                   or {}}}
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    out = {"calls": n, "wall_ms": wall_us / 1e3, "records_whole": True,
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
