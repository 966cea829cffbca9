"""The benchmark's harness on the CPU: cells, configurations and metrics
found by name from files, BENCHMARK.json against its contract, the last
line's keys, no fallback without a card, the import bans, the trace
reader and the counting functions against hand counts."""
import ast
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import counting, harness, trace, weights
from bench.drivers import lm_prefill, rl_train

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ discovery

@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = harness.Cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert hasattr(cell.driver(), "run")
    assert set(cell.limits["limits"])
    assert cell.per_layer and cell.end_to_end


@pytest.mark.parametrize("name", METRICS)
def test_metric_found_by_name_and_its_spans_resolve(name):
    mod = harness.load_metric(name)
    assert callable(mod.read)
    for target in getattr(mod, "SPANS", {}).values():
        owner, attr = trace.resolve(target)
        assert callable(getattr(owner, attr))


def test_a_missing_entry_point_fails_loudly():
    with pytest.raises(AttributeError):
        trace.resolve("repro_torch.models.moe:no_such_function")


def test_unknown_cell_fails():
    with pytest.raises(KeyError):
        harness.Cell("no-such-cell")


# ------------------------------------------------------------ the contract

def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1] == "bench/run.py"
    assert (ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for name in CELLS:
        cell = harness.Cell(name)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in got


def test_check_budget_fits_24_cells():
    s = SPEC["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


# ------------------------------------------------------------ runs

def tiny_trunk():
    return dict(name="tiny-trunk", family="dense", n_layers=2, d_model=32,
                n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64, vocab=64,
                layer_pattern=["attn"], norm="rmsnorm", rope_theta=10000.0,
                dtype="float32", use_kernels=True)


def tiny_ppo_cell():
    traffic = harness.load_json(ROOT / "bench/traffic/ppo-cartpole-4096.json")
    traffic.update(n_envs=16, unroll=4, superstep=3)
    return harness.Cell.of("tiny-ppo", tiny_trunk(), traffic,
                           harness.Cell("ppo-trunk-cartpole-4096").limits)


def test_last_line_keys_of_a_run(one_thread):
    out = rl_train.run(tiny_ppo_cell(), seed=2 ** 31 + 17, seconds=0.2,
                       trace=False, device="cpu", t_start=0.0)
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"env_steps_per_s", "peak_mem_gib",
                                   "setup_s"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        CELLS[0], "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_banned_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro_torch_fake" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro.core" in harness.banned_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


BENCH_FILES = sorted(p.relative_to(ROOT).as_posix()
                     for p in (ROOT / "bench").rglob("*.py"))


@pytest.mark.parametrize("rel", BENCH_FILES)
def test_no_jax_or_jax_package_imported(rel):
    for name in _imports(ROOT / rel):
        assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "repro",
                                          "benchmarks"), (rel, name)


@pytest.mark.parametrize("rel", [r for r in BENCH_FILES
                                 if r.startswith("bench/refs/")])
def test_references_import_nothing_of_the_program(rel):
    for name in _imports(ROOT / rel):
        top = name.split(".")[0]
        assert top in ("torch", "numpy", "math", "contextlib", "__future__",
                       "bench"), (rel, name)
        if top == "bench":
            assert name.startswith("bench.refs"), (rel, name)


# ------------------------------------------------------------ counting

def test_attention_counts_by_hand():
    # B=1, H=2, KVH=1, S=3, D=4, causal: 1*2*(3*4/2) = 12 pairs
    assert counting.attention_fwd_work(1, 2, 1, 3, 4) == (4 * 4 * 12, 4 * (
        2 * 3 * 2 * 4 + 2 * 3 * 1 * 4))
    f, b = counting.attention_fwd_work(1, 2, 1, 3, 4, lse=True)
    assert b == 288 + 4 * 2 * 3
    assert counting.attention_bwd_work(1, 2, 1, 3, 4) == (
        10 * 4 * 12, 4 * (3 * 24 + 2 * 12) + 4 * 6 + 4 * (24 + 24))


def test_gmm_counts_by_hand():
    # rows 2, 0, 1 of d=3 into f=5: 3 rows, 2 experts' weights
    assert counting.gmm_work([2, 0, 1], 3, 5) == (2 * 3 * 3 * 5, 4 * (
        3 * 3 + 2 * 3 * 5 + 3 * 5))


def test_bound_takes_the_larger_term():
    assert counting.bound_s(67e12, 0) == pytest.approx(1.0)
    assert counting.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_trunk_and_prefill_flops_by_hand():
    cfg = dict(n_layers=1, d_model=4, n_heads=2, n_kv_heads=1, head_dim=2,
               d_ff=8, vocab=10)
    # one layer: q,o 2*4*2*2*2 = 64, k,v 2*4*1*2*2 = 32, attn at ctx c:
    # 2*c*2*2*2 = 16c, SwiGLU 6*4*8 = 192
    per_tok = lambda c: 64 + 32 + 16 * c + 192
    assert counting.blocks_flops_per_token(cfg, 1.5) == per_tok(1.5)
    assert counting.prefill_flops(cfg, 4) == 4 * per_tok(1.5) + 2 * 4 * 10
    # 3 samples, 2 positions, 2 actions: lift 2*4 a position, heads 2*4*3
    assert counting.trunk_forward_flops(cfg, 3, 2, 2) == 3 * (
        2 * (8 + per_tok(0.5)) + 24)


def test_moe_flops_match_the_programs_analytic():
    from repro_torch.configs.base import get_config
    from repro_torch.launch.analytic import fwd_flops_per_token
    cfg = harness.Cell("deepseek-moe-16b-f32-prefill").config
    cfg = dict(cfg, head_dim=cfg["d_model"] // cfg["n_heads"])
    for ctx in (255.5, 2047.5):
        want = fwd_flops_per_token(get_config("deepseek-moe-16b"), ctx)
        got = counting.blocks_flops_per_token(cfg, ctx) \
            + 2 * cfg["d_model"] * cfg["vocab"]
        assert got == pytest.approx(want, rel=1e-12)


# ------------------------------------------------------------ trace reader

def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_reading_attributes_kernels_to_spans_by_launch_time():
    events = [
        _x("user_annotation", "bench.outer", 0, 100),
        _x("user_annotation", "bench.inner", 10, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 1, correlation=3),
        _x("kernel", "k_a", 100, 30, correlation=1),
        _x("kernel", "k_b", 200, 10, correlation=2),
        _x("kernel", "k_c", 205, 20, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoH", 300, 5),
        _x("cpu_op", "aten::item", 225, 80),
    ]
    r = trace.Reading(events, 400e-6)
    assert r.whole
    assert r.device_s("bench.inner") == pytest.approx(30e-6)
    assert r.device_s("bench.outer") == pytest.approx(40e-6)
    assert r.device_s("bench.outer", "bench.inner") == pytest.approx(40e-6)
    # the union of [100,130], [200,225], [300,305]
    assert r.busy_s == pytest.approx(60e-6)
    b = r.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(30e-6)]
    assert b["idle_gaps"][0] == ["aten::item", pytest.approx(75e-6)]


def test_a_reading_that_lost_kernel_records_is_not_whole():
    events = [_x("cuda_runtime", "cudaLaunchKernel", 1, 1, correlation=1),
              _x("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=2),
              _x("kernel", "k", 5, 1, correlation=1)]
    assert not trace.Reading(events, 1e-5).whole


def test_spans_wrap_and_restore():
    import repro_torch.models.moe as moe
    spans = trace.Spans()
    seen = []
    spans.add("bench.gmm", "repro_torch.models.moe:_gmm",
              lambda a, k, o: seen.append(a[0].shape))
    before = moe._gmm
    x, w = torch.ones(2, 3, 4), torch.ones(2, 4, 5)
    with spans:
        assert moe._gmm is not before
        moe._gmm(x, w, False)            # inactive: counts nothing
        spans.active = True
        moe._gmm(x, w, False)
        spans.active = False
    assert moe._gmm is before and seen == [(2, 3, 4)]


# ------------------------------------------------------------ data

def test_weights_come_from_the_seed():
    shapes = {"a/mixer/wq": (4, 2, 3), "a/norm1/scale": (4,), "pi/b": (2,),
              "pi/w": (4, 2)}
    a = weights.draw(shapes, 5, "cpu")
    b = weights.draw(shapes, 5, "cpu")
    c = weights.draw(shapes, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["a/mixer/wq"], c["a/mixer/wq"])
    assert torch.equal(a["a/norm1/scale"], torch.ones(4))
    assert torch.equal(a["pi/b"], torch.zeros(2))
    assert float(a["pi/w"].abs().max()) < 0.1


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 40 + 1])
def test_every_seed_sends_the_same_lengths_by_round(seed):
    t = harness.Cell("deepseek-moe-16b-f32-prefill").traffic
    base = lm_prefill.schedule(t, 12345)
    got = lm_prefill.schedule(t, seed)
    k = t["strata"]
    for r in range(0, 40 * k, k):
        assert sorted(got[r:r + k]) == sorted(base[r:r + k])
    ls = lm_prefill.lengths(t)
    assert ls[0] >= t["min_len"] and ls[-1] <= t["max_len"]
    assert sum(ls) / len(ls) == pytest.approx(1723.5, abs=1)


def test_percentile_and_checks():
    assert harness.percentile([1, 2, 3, 4, 5], 90) == pytest.approx(4.6)
    got, ok = harness.checks({"a": 1.0}, {"limits": {"a": {"limit": 2.0}}})
    assert ok and got == {"a": {"value": 1.0, "limit": 2.0}}
    _, ok = harness.checks({"a": math.inf}, {"limits": {"a": {"limit": 2}}})
    assert not ok
    with pytest.raises(KeyError):
        harness.checks({}, {"limits": {"a": {"limit": 2.0}}})
