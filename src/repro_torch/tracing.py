"""The port's spans and counters, recorded only while a profiler records.

Spans name where the work happens: the RL loop, the learner and its
optimizer, the LM prefill, attention and the MoE dispatch. Their names
are the package's, `repro_torch.<layer>...`. While a `torch.profiler`
session records, a span is a `torch.profiler.record_function` user
annotation in the same Kineto trace as the kernels and copies, so it
shares the device trace's clock, and its parent is the span that holds it
on the host timeline. With no profiler recording, a span is one C call
and a shared no-op context: nothing is recorded and nothing is kept.

A counter appends a value the program has already computed (a Python
number, a tensor, or a dict of them) while a profiler records,
and nothing otherwise: it launches no kernel and never syncs.
`read_counters()` moves every device value to the host in one copy, so
call it after the traced stretch's closing sync.

  with span("repro_torch.moe.dispatch"): ...     # a block
  @spanned("repro_torch.lm.prefill")             # a whole function
  count("repro_torch.moe.expert_load", {...})    # a record
  with record("trace.json"): ...                 # trace a stretch, write
                                                 # it and its counters
"""
from __future__ import annotations

import contextlib
import functools
import json

import torch
from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_counters: dict = {}


def span(name):
    """A context that records the span `name` while a profiler records,
    else the shared no-op context."""
    return record_function(name) if _profiler_enabled() else _OFF


def spanned(name):
    """Decorator: every call of the function runs under `span(name)`,
    the profiler's state read at call time."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name, value):
    """Appends `value` to the counter `name` while a profiler records."""
    if _profiler_enabled():
        _counters.setdefault(name, []).append(value)


def reset_counters():
    _counters.clear()


def _fields(record):
    return record.values() if isinstance(record, dict) else (record,)


def read_counters():
    """{counter name: [record, ...]} in the order appended, every tensor
    as a (nested) list of host numbers. A record is a number, a tensor or
    a dict of them; the device tensors move in one copy a device."""
    host, by_device = {}, {}
    for records in _counters.values():
        for record in records:
            for v in _fields(record):
                if isinstance(v, torch.Tensor):
                    by_device.setdefault(v.device, []).append(v)
    for ts in by_device.values():
        # float64 holds every integer count exactly (below 2**53)
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                          for t in ts]).cpu()
        at = 0
        for t in ts:
            n = t.numel()
            host[id(t)] = flat[at:at + n].reshape(t.shape).to(
                t.dtype).tolist()
            at += n

    def to_host(v):
        return host[id(v)] if isinstance(v, torch.Tensor) else v

    return {name: [{k: to_host(v) for k, v in r.items()}
                   if isinstance(r, dict) else to_host(r) for r in records]
            for name, records in _counters.items()}


@contextlib.contextmanager
def record(path):
    """Traces the block with torch.profiler (host ops, and the card's
    kernels and copies where CUDA is up) and writes the Chrome trace to
    `path` and `read_counters()` as JSON beside it (`x.json` ->
    `x.counters.json`). The counters start empty; the block ends in a
    device sync."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    reset_counters()
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    path = str(path)
    prof.export_chrome_trace(path)
    stem = path[:-5] if path.endswith(".json") else path
    with open(stem + ".counters.json", "w") as f:
        json.dump(read_counters(), f)
    reset_counters()
