"""The data-driven part of the harness: a cell is found by its name in
`BENCHMARK.json`, and everything that belongs to it by file name.

  * the configuration: its `file` in `BENCHMARK.json` (sizes, dtype, the
    reference that checks it);
  * the traffic mix: `bench/traffic/<traffic>.json`, whose `driver` names
    the entry kind (`bench/drivers/<driver>.py`) and whose other keys are
    the driver's parameters;
  * the limits of the output check: `bench/limits/<workload>.json`;
  * each per-layer metric: `bench/metrics/<metric name>.py`, with the
    spans it needs (`SPANS`), an optional per-call `count` and `read`.

A later cell, configuration or metric is new files and new entries; no
file here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BANNED = ("jax", "jaxlib", "flax", "repro")   # top-level names, whole


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its files."""

    def __init__(self, name):
        spec = load_json(ROOT / "BENCHMARK.json")
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                           f"{sorted(by_name)}")
        self.name = name
        self.entry = by_name[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(ROOT / self.config_entry["file"])
        self.traffic = load_json(BENCH / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = load_json(BENCH / "limits" / f"{name}.json")
        self.chips = self.entry["chips"]
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])]

    @classmethod
    def of(cls, name, config, traffic, limits, chips=1, per_layer=()):
        """A cell from its parts, not from files (the CPU tests' small
        cells)."""
        cell = cls.__new__(cls)
        cell.name, cell.entry = name, {"name": name, "chips": chips}
        cell.config, cell.traffic, cell.limits = config, traffic, limits
        cell.chips, cell.end_to_end = chips, []
        cell.per_layer = list(per_layer)
        return cell

    def driver(self):
        return importlib.import_module(f"bench.drivers.{self.traffic['driver']}")

    def metrics(self):
        """[(metric entry, its reader module)] of this cell's per-layer
        metrics."""
        return [(m, load_metric(m["name"])) for m in self.per_layer]


def load_metric(name):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class MetricRun:
    """What a reader sees: the traced window's Reading, the driver's
    `info` (counts of the run) and the metric's own `state`, which its
    `count` filled call by call."""

    def __init__(self, reading, info, state):
        self.reading, self.info, self.state = reading, info, state


def install_spans(spans, metrics):
    """Each metric's spans and counters into `spans` (a trace.Spans);
    returns {metric name: its state dict}."""
    states = {}
    for entry, mod in metrics:
        state = states[entry["name"]] = {}
        spans.resets.append(state.clear)
        count = getattr(mod, "count", None)
        for span, target in getattr(mod, "SPANS", {}).items():
            counter = None
            if count is not None:
                counter = (lambda a, k, o, s=state, sp=span, c=count:
                           c(s, sp, a, k, o))
            spans.add(span, target, counter)
    return states


def read_metrics(metrics, reading, info, states):
    """{name: {"value", "unit"}} of the metrics whose reader found
    something to read; a reader that returns None is left out."""
    out = {}
    for entry, mod in metrics:
        value = mod.read(MetricRun(reading, info, states[entry["name"]]))
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out


def banned_modules():
    """Loaded modules whose top-level name is one the benchmark bans."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in BANNED)


def percentile(values, q):
    """The q-th percentile (0..100), linear between order statistics."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def checks(numbers, limits):
    """{name: {"value", "limit"}} and whether every number is within its
    limit; a number the limits file does not hold is an error."""
    out, ok = {}, True
    for name, value in numbers.items():
        if name not in limits["limits"]:
            raise KeyError(f"no limit for {name!r}")
        limit = limits["limits"][name]["limit"]
        out[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    missing = set(limits["limits"]) - set(numbers)
    if missing:
        raise KeyError(f"the check gave no {sorted(missing)}")
    return out, ok


def device_info(chips, peak_bytes):
    """The result's `device`: the card's name, the cards used and the peak
    of device memory on the fullest, read as the window closed."""
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak_bytes}

