"""The port's six examples (examples/repro_torch/*.py) and the policy
serving launcher's repro-bench/v1 record, run as subprocesses at
`--device cpu`, all started together, each in a temp directory (the
examples write their checkpoints under the working directory).
train_lm and serve_lm run at the smallest settings their flags allow
that keep train_lm's learning bar (300 reduced steps); the other four
have no flags to shrink them and run at their own settings."""
import json
import math
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = os.path.join(ROOT, "examples", "repro_torch")

RUNS = {
    "quickstart": ["quickstart.py"],
    "train_lm": ["train_lm.py", "--batch", "8", "--seq", "32"],
    "serve_lm": ["serve_lm.py", "--batch", "2", "--prompt-len", "8",
                 "--gen-len", "4"],
    "impala_pendulum": ["impala_pendulum.py"],
    "es_cartpole": ["es_cartpole.py"],
    "serve_policy_cartpole": ["serve_policy_cartpole.py"],
    "serve_policy": ["-m", "repro_torch.launch.serve_policy", "--quick",
                     "--out", "."],
}
LM_BAR_MARGIN = 0.25   # chip_smoke.py's: final CE <= optimal_ce + 0.25


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (stdout, working directory) once that run has ended."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for name, argv in RUNS.items():
        cwd = tmp_path_factory.mktemp(name)
        cmd = argv if argv[0] == "-m" else [os.path.join(EXAMPLES, argv[0]),
                                            *argv[1:]]
        procs[name] = (subprocess.Popen(
            [sys.executable, *cmd, "--device", "cpu"], cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), cwd)
    done = {}

    def result(name):
        if name not in done:
            proc, cwd = procs[name]
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-3000:]
            done[name] = (stdout, cwd)
        return done[name]

    yield result
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _field(text, key):
    return float(re.search(rf"{key}=(-?[\d.]+)", text).group(1))


def test_quickstart(runs):
    out, _ = runs("quickstart")
    heads = [ln.split(":")[0] for ln in out.splitlines()]
    for head in ("train", "serve", "impala", "impala/pipelined",
                 "serve_policy", "es"):
        assert head in heads, (head, out)
    assert "depth=1 queue_capacity=1" in out
    assert re.search(r"compiles=(\d+) \(was \1 before hot-swap\)", out)
    assert math.isfinite(_field(out, "mean_fitness"))


def test_train_lm_reaches_its_bar(runs):
    out, cwd = runs("train_lm")
    final, floor = _field(out, "final_ce"), _field(out, "entropy_floor")
    assert final <= floor + LM_BAR_MARGIN, out
    assert os.path.exists(os.path.join(
        cwd, "experiments", "ckpt_torch_smollm-360m.npz"))


def test_serve_lm(runs):
    out, _ = runs("serve_lm")
    res = json.loads(out)
    assert res["generated_shape"] == [2, 4] and res["device"] == "cpu"
    assert res["arch"] == "rwkv6-1.6b"


def test_impala_pendulum(runs):
    out, _ = runs("impala_pendulum")
    got = re.findall(r"lag=(\d) vtrace=(\w+): return=(-?[\d.]+)", out)
    assert [(lag, v) for lag, v, _ in got] == [
        ("0", "True"), ("0", "False"), ("4", "True"), ("4", "False")]
    assert all(math.isfinite(float(r)) for _, _, r in got)


def test_es_cartpole(runs):
    out, _ = runs("es_cartpole")
    es = [float(x) for x in re.findall(r"ES gen \d+: mean_fitness=([\d.]+)",
                                       out)]
    ga = [float(x) for x in re.findall(r"GA gen \d+: best_fitness=([\d.]+)",
                                       out)]
    assert len(es) == len(ga) == 10
    assert all(math.isfinite(f) for f in es + ga)
    assert "actor_shards=[16, 32, 16, 32]" in out


def test_serve_policy_cartpole_restores_and_serves(runs):
    out, _ = runs("serve_policy_cartpole")
    assert "warmup compiles: 2" in out and "compiles: 2" in out
    assert "versions_served=2" in out


def test_serve_policy_writes_a_valid_bench_record(runs):
    """`--out DIR` writes BENCH_torch_serve.json (never the JAX package's
    BENCH_serve.json), valid for the port's validator and the
    reference's."""
    sys.path.insert(0, ROOT)
    from benchmarks.common import validate_bench_json as jax_validate
    from repro_torch.launch.bench_record import validate_bench_json
    out, cwd = runs("serve_policy")
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["bench"] == "BENCH_torch_serve.json"
    assert os.listdir(cwd) == ["BENCH_torch_serve.json"]
    with open(os.path.join(cwd, "BENCH_torch_serve.json")) as f:
        doc = json.load(f)
    validate_bench_json(doc)
    jax_validate(doc)
    assert doc["backend"] == "cpu" and doc["benchmark"] == "serve"
    assert doc["meta"]["quick"] is True and doc["meta"]["device"] == "cpu"
    assert "device_name" not in doc["meta"]
    names = [r["name"] for r in doc["rows"]]
    assert names[-1] == "serve/compile_flat" and len(names) == 5
    assert "recompiles_after_warmup=0" in doc["rows"][-1]["derived"]


def test_bench_record_rejects_a_malformed_doc(tmp_path):
    import torch

    from repro_torch.launch.bench_record import (validate_bench_json,
                                                 write_bench_json)
    path = write_bench_json("x", [("a", 1.234, "d")], torch.device("cpu"),
                            out_dir=str(tmp_path), k=1)
    assert os.path.basename(path) == "BENCH_torch_x.json"
    with open(path) as f:
        doc = json.load(f)
    assert doc["rows"] == [{"name": "a", "us_per_call": 1.23,
                            "derived": "d"}]
    assert doc["meta"] == {"k": 1, "quick": False, "device": "cpu"}
    for mutate, frag in [
            (lambda d: d.update(schema="v2"), "schema"),
            (lambda d: d.update(rows="nope"), "rows"),
            (lambda d: d["rows"].append({"name": 1}), "rows[1]"),
            (lambda d: d["rows"][0].update(derived=7), "derived")]:
        bad = json.loads(json.dumps(doc))
        mutate(bad)
        with pytest.raises(ValueError, match=re.escape(frag)):
            validate_bench_json(bad)
    with pytest.raises(ValueError, match="us_per_call"):
        write_bench_json("y", [("a", "slow", "d")], torch.device("cpu"),
                         out_dir=str(tmp_path))
    assert not os.path.exists(tmp_path / "BENCH_torch_y.json")
