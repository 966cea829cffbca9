"""Spans from the benchmark's own files, and the reading of a device trace.

A per-layer metric names the program's entry points it needs
(`SPANS = {"bench.attn": "repro_torch.models.attention:core_attention"}`).
The harness replaces each one with a wrapper that, while a traced window
is open, runs the call under `torch.profiler.record_function(<span>)` and
then hands the call's arguments to the metric's `count`. A target that no
longer exists raises: a reader never reports a number for code it could
not wrap.

`Window` traces a stretch of the run with torch.profiler (host ops and
CUDA activity), writes the Chrome trace under the temp directory, reads
it and deletes it. A kernel belongs to every span whose host interval
holds the host call that launched it (the trace's correlation ids), on
whatever thread: autograd runs a backward on a thread of its own, inside
the learner's call. A window that lost kernel records (fewer kernel
records than launch calls, the rule of the port's `launch/profiling.py`
`records_whole`) is traced again.
"""
from __future__ import annotations

import bisect
import functools
import gzip
import importlib
import json
import os
import tempfile
import time

TRIES = 5


class Spans:
    """The span wrappers of one run, installed on entry, removed on exit."""

    def __init__(self):
        self.active = False
        self._targets = {}      # span name -> "module:attr"
        self._counters = {}     # span name -> [callable(args, kwargs, out)]
        self.resets = []        # emptied counters: each traced try starts bare
        self._undo = []

    def add(self, name, target, counter=None):
        if self._targets.setdefault(name, target) != target:
            raise ValueError(f"span {name!r} names two entry points: "
                             f"{self._targets[name]} and {target}")
        if counter is not None:
            self._counters.setdefault(name, []).append(counter)

    def __enter__(self):
        for name, target in self._targets.items():
            owner, attr = resolve(target)
            fn = owner.__dict__[attr] if isinstance(owner, type) else \
                getattr(owner, attr)
            setattr(owner, attr, self._wrap(fn, name,
                                            self._counters.get(name, [])))
            self._undo.append((owner, attr, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()

    def _wrap(self, fn, name, counters):
        from torch.profiler import record_function

        @functools.wraps(fn)
        def span(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            with record_function(name):
                out = fn(*args, **kwargs)
            for count in counters:
                count(args, kwargs, out)
            return out
        return span


def resolve(target):
    """"pkg.module:Attr.attr" -> (the object that holds the last attribute,
    its name); raises where the program no longer has it."""
    mod_name, _, path = target.partition(":")
    obj = importlib.import_module(mod_name)
    *parents, attr = path.split(".")
    for p in parents:
        obj = getattr(obj, p)
    held = obj.__dict__ if isinstance(obj, type) else vars(obj)
    if attr not in held:
        raise AttributeError(f"the program has no {target}: a span of the "
                             f"benchmark wraps it")
    return obj, attr


class Window:
    """One traced stretch: `start()`, the work, `stop()`."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.t0 = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        for reset in self.spans.resets:
            reset()
        self.prof.start()
        self.spans.active = True
        self.t0 = time.perf_counter()

    def stop(self):
        """Ends the window -> its Reading, or None when it lost records."""
        import torch
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.spans.active = False
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path, "rb") as f:
                head = f.read(2)
            opener = gzip.open if head == b"\x1f\x8b" else open
            with opener(path, "rt") as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        reading = Reading(events, wall)
        return reading if reading.whole else None


def traced(spans, run_once, tries=TRIES):
    """`run_once()` under a Window until one keeps every kernel record ->
    (Reading or None, the tries made)."""
    for n in range(1, tries + 1):
        w = Window(spans)
        w.start()
        run_once()
        r = w.stop()
        if r is not None:
            return r, n
    return None, tries


def _launch(e):
    return (e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "Launch" in e.get("name", "") and "Kernel" in e["name"])


class Reading:
    """What a Chrome trace of one window says: kernel time under each span,
    the device's busy time, the heaviest kernels and the longest idle gaps.
    Times in seconds."""

    def __init__(self, events, wall_s):
        self.window_s = wall_s
        kernels, device_ops, launches, spans, host = [], [], {}, {}, []
        n_launch = 0
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat == "kernel":
                kernels.append(e)
                device_ops.append(e)
            elif cat in ("gpu_memcpy", "gpu_memset"):
                device_ops.append(e)
            elif _launch(e):
                n_launch += 1
                launches[e.get("args", {}).get("correlation")] = e["ts"]
            elif cat == "user_annotation" and e["name"].startswith("bench."):
                spans.setdefault(e["name"], []).append(
                    (e["ts"], e["ts"] + e["dur"]))
            if cat in ("cpu_op", "user_annotation", "cuda_runtime"):
                host.append(e)
        self.n_kernels, self.n_launches = len(kernels), n_launch
        self.whole = len(kernels) > 0 and len(kernels) >= n_launch
        for ivs in spans.values():
            ivs.sort()
        self._spans = spans
        self.calls = {k: len(v) for k, v in spans.items()}
        self.span_s = {k: 0.0 for k in spans}
        self.by_name = {}
        for e in device_ops:
            self.by_name[e["name"]] = (self.by_name.get(e["name"], 0.0)
                                       + e["dur"] / 1e6)
        self._kernel_spans = []
        for e in kernels:
            at = launches.get(e.get("args", {}).get("correlation"))
            inside = [] if at is None else self._spans_at(at)
            for name in inside:
                self.span_s[name] += e["dur"] / 1e6
            self._kernel_spans.append((e["dur"] / 1e6, inside))
        ivs = sorted((e["ts"], e["ts"] + e["dur"]) for e in device_ops)
        busy, gaps = 0.0, []
        cur = None
        for a, b in ivs:
            if cur is None:
                cur = [a, b]
            elif a > cur[1]:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], a))
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
        if cur is not None:
            busy += cur[1] - cur[0]
        self.busy_s = busy / 1e6
        self._gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        self._host = host

    def _spans_at(self, t):
        out = []
        for name, ivs in self._spans.items():
            i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
                out.append(name)
        return out

    def device_s(self, *names):
        """Kernel seconds under any of the spans `names`, each kernel once."""
        want = set(names)
        return sum(dur for dur, inside in self._kernel_spans
                   if want.intersection(inside))

    def breakdown(self):
        """The device operations that took most time and the longest idle
        gaps, each gap named by the innermost host op running as it began."""
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = []
        for a, b in self._gaps:
            best = None
            for e in self._host:
                if e["ts"] <= a <= e["ts"] + e["dur"] and (
                        best is None or e["dur"] < best["dur"]):
                    best = e
            label = best["name"] if best is not None else "no host op"
            gaps.append([label[:80], (b - a) / 1e6])
        return {"device_ops": [[k[:80], v] for k, v in ops],
                "idle_gaps": gaps}

