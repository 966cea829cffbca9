"""`gmm_tiles_run_pct` on the CPU: declared for the deepseek cell, a hand
count off the grouped matmul's row tiles counter, and nothing where the
program recorded none or has no counter (an older program)."""
import sys

import pytest

from bench import harness, trace

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = "gmm_tiles_run_pct"


def test_gmm_tiles_run_is_declared_and_reads_nothing_on_an_empty_reading():
    from repro_torch import tracing
    entry = {m["name"]: m for m in SPEC["per_layer"]}[NAME]
    assert entry["workloads"] == ["deepseek-moe-16b-f32-prefill"]
    assert entry["moves"] == "prefill_tok_per_s"
    tracing.reset_counters()
    mod = harness.load_metric(NAME)
    assert mod.read(harness.MetricRun(trace.Reading([], 0.0), {}, {})) \
        is None


def test_gmm_tiles_run_reads_the_row_tiles_counter(monkeypatch):
    from repro_torch import tracing
    records = [{"rows": [0, 64, 65, 300], "capacity": 202, "tile": 64},
               {"rows": [8, 0], "capacity": 8, "tile": 8}]
    monkeypatch.setattr(tracing, "read_counters",
                        lambda: {"repro_torch.gmm.row_tiles": records})
    mod = harness.load_metric(NAME)
    got = mod.read(harness.MetricRun(None, {}, {}))
    # tiles of 64 rows, 4 an expert at C = 202: 0 + 1 + 2 + 4 (300 clamped
    # to 202) of 16; then 1 + 0 of 2
    assert got == pytest.approx(8 / 18 * 100)


def test_gmm_tiles_run_reads_nothing_from_a_program_without_it(
        monkeypatch):
    """The parent program records no row tiles (its counter dict lacks
    the name), and a program without tracing cannot be asked."""
    from repro_torch import tracing
    mod = harness.load_metric(NAME)
    monkeypatch.setattr(tracing, "read_counters", lambda: {
        "repro_torch.moe.expert_load": [
            {"load": [1, 2], "capacity": 8, "assigned": 3}]})
    assert mod.read(harness.MetricRun(None, {}, {})) is None
    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    assert mod.read(harness.MetricRun(None, {}, {})) is None
