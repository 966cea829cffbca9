"""The per-layer readers beside the program's own spans and counters, on
the CPU: every reader reads the same value on a trace that also holds
the program's `repro_torch.*` annotations; `gmm_fill_pct` reads the
experts' load counter (a hand count), and nothing where the program has
no counter or recorded none (an older program)."""
import sys

import pytest
import torch

from bench import harness, trace

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
OLD = ["rollout_ms", "learner_ms", "mfu_pct.rl", "attn_roofline_pct.rl",
       "device_idle_pct.rl", "mfu_pct.lm", "moe_dispatch_ms",
       "gmm_roofline_pct", "attn_roofline_pct.lm", "device_idle_pct.lm"]
NEW = ["gmm_fill_pct"]


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _events():
    """Spans of the benchmark's wrappers, a kernel under each, copies and
    idle gaps."""
    spans = [("bench.produce", 0, 100), ("bench.attn", 10, 20),
             ("bench.consume", 100, 200), ("bench.attn", 120, 10),
             ("bench.attn_bwd", 200, 10), ("bench.moe", 400, 200),
             ("bench.gmm", 420, 20), ("bench.moe_shared", 500, 20)]
    launches = [15, 50, 125, 205, 250, 430, 510, 550]
    ev = [_x("user_annotation", n, a, d) for n, a, d in spans]
    for i, t in enumerate(launches):
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", t, 1,
                     correlation=i + 1))
        ev.append(_x("kernel", f"k{i}", 700 + 40 * i, 10 + 3 * i,
                     correlation=i + 1))
    ev.append(_x("gpu_memcpy", "Memcpy DtoH", 1100, 5))
    ev.append(_x("cpu_op", "aten::item", 1000, 110))
    return ev


# the program's spans, some over the benchmark's, some across them
PROGRAM = [("repro_torch.rl.rollout", 0, 100),
           ("repro_torch.rl.rollout.policy", 12, 40),
           ("repro_torch.attention", 10, 20),
           ("repro_torch.rl.learner", 100, 200),
           ("repro_torch.rl.learner.optimizer", 240, 30),
           ("repro_torch.attention.backward", 200, 10),
           ("repro_torch.lm.prefill", 380, 300),
           ("repro_torch.moe", 400, 200),
           ("repro_torch.moe.experts", 420, 20),
           ("repro_torch.moe.dispatch", 445, 60),
           ("repro_torch.lm.sample", 990, 200)]


def _run(events):
    reading = trace.Reading(events, 1200e-6)
    info = {"window_s": 2.0, "window_flops": 3e13, "window_iters": 20,
            "iteration_flops": 2e12, "traced_requests": 2}
    states = {"attn_roofline_pct.rl": {"bound_s": 1e-5},
              "attn_roofline_pct.lm": {"bound_s": 2e-5},
              "gmm_roofline_pct": {"calls": [(torch.tensor([3, 0, 2]),
                                              64, 32)]}}
    return {name: harness.load_metric(name).read(
        harness.MetricRun(reading, info, states.get(name, {})))
        for name in OLD}


def test_every_reader_reads_the_same_beside_the_programs_spans():
    bare = _run(_events())
    assert all(v is not None for v in bare.values()), bare
    with_program = _run(_events() + [_x("user_annotation", n, a, d)
                                     for n, a, d in PROGRAM])
    assert with_program == bare


@pytest.mark.parametrize("name", NEW)
def test_new_metric_is_declared_and_reads_nothing_on_an_empty_reading(name):
    from repro_torch import tracing
    entry = {m["name"]: m for m in SPEC["per_layer"]}[name]
    assert entry["workloads"] == ["deepseek-moe-16b-f32-prefill"]
    tracing.reset_counters()
    mod = harness.load_metric(name)
    assert mod.read(harness.MetricRun(trace.Reading([], 0.0), {}, {})) \
        is None


def test_gmm_fill_reads_the_expert_load_counter(monkeypatch):
    from repro_torch import tracing
    records = [{"load": [10, 0, 3, 7], "capacity": 8, "assigned": 20},
               {"load": [2, 2, 2, 2], "capacity": 8, "assigned": 8}]
    monkeypatch.setattr(tracing, "read_counters",
                        lambda: {"repro_torch.moe.expert_load": records})
    mod = harness.load_metric("gmm_fill_pct")
    got = mod.read(harness.MetricRun(None, {}, {}))
    # routed rows (8 + 0 + 3 + 7) + 8 of 2 x 4 x 8 slots
    assert got == pytest.approx(26 / 64 * 100)


def test_gmm_fill_reads_nothing_from_a_program_without_tracing(monkeypatch):
    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    mod = harness.load_metric("gmm_fill_pct")
    assert mod.read(harness.MetricRun(None, {}, {})) is None
