"""One process a data position (repro_torch.core.positions'
`ProcessPositions` and `run_processes`, `Trainer(positions=...)`,
`rl_train --backend gloo|nccl`) on the CPU over gloo, against the threaded
`PositionGroup` and the JAX package:

  (a) the collectives: the hooks of `compile_collectives` for flat(4) and
      grid(2, 2) with every inter-host collective over 4 processes,
      bitwise the threaded group's and within 1e-6 of JAX under nested
      vmap; `shard_gather` and the metrics' all-gather bitwise;
  (b) whole fits over 2 or 4 processes, bitwise the threaded fit (every
      part of the state and the history): impala flat(4), a
      (hosts=2 allreduce bsp, workers=2 gossip asp) grid, workers=2 x
      shard=2 and x zero3=2, a3c under an elastic `actors=16,32`, dqn
      under workers=2 x replay=2 (the flat buffer back) and a3c
      pipelined under ssp, staleness bound 1;
  (c) no hang: a rank that raises makes the launcher raise at once,
      naming it, and stops the others; a rank that stays away from a
      collective makes the others time out;
  (d) the CLI: `--backend gloo` prints the `--backend positions` line
      plus `backend` and `n_processes`; `--backend nccl` without a card
      a rank refuses before it starts a process.

Each spawn of processes runs several cases, with a deadline, one
intra-op thread a process (and the threaded references one thread too:
the CPU's reductions may depend on the thread count). The build lock
(several processes building the kernels at once) is in
tests/test_torch_kernel_build.py.
"""
import contextlib
import json
import multiprocessing
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_process_cases as cases
from repro.core.distribution import DistPlan as JaxPlan
from repro_torch.core.positions import (PositionGroup, RankFailed,
                                         run_processes, tree_leaves)
from repro_torch.launch import rl_train

DEADLINE_S = 240
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def spawn(fn, args, n, **kw):
    return run_processes(fn, args, n=n, backend="gloo",
                         devices=["cpu"] * n, threads=1,
                         deadline=kw.pop("deadline", DEADLINE_S), **kw)


W4 = [name for name in cases.FITS
      if cases.config(name).plan.sim_devices == 4]
W2 = [name for name in cases.FITS if name not in W4]


@pytest.fixture(scope="module")
def ranks():
    """Every case, run once: {W: each rank's `rank_main` result}."""
    return {4: spawn(cases.rank_main, (W4,), 4),
            2: spawn(cases.rank_main, (W2,), 2)}


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _same_state(a, b):
    for part in ("params", "opt_state", "extra", "ring", "steps"):
        la = tree_leaves(getattr(a, part))
        lb = tree_leaves(getattr(b, part))
        assert len(la) == len(lb), part
        assert all(_equal(x, y) if isinstance(x, torch.Tensor) else x == y
                   for x, y in zip(la, lb)), part


# ------------------------------------------------------ (a) collectives
def _nested(fn, names):
    for name in reversed(names):
        fn = jax.vmap(fn, axis_name=name)
    return fn


@pytest.mark.parametrize("spec", cases.SPECS)
def test_hooks_over_processes_match_threads_and_jax(ranks, spec):
    got = [r["hooks"][spec] for r in ranks[4]]
    group = PositionGroup(4)
    try:
        threaded = group.run(lambda r: cases.hooks(
            group, spec, r, cases.own_grads(spec, r)))
    finally:
        group.close()
    ref = JaxPlan.parse(spec)
    g = cases.grads(ref.mesh_shape, len(spec))
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    for label, jfn in zip(("grad", "param"), ref.compile_collectives()):
        if jfn is None:
            assert all(label not in r for r in got)
            continue
        want = _nested(jfn, ref.axis_names)(jg)
        for r in range(4):
            at = np.unravel_index(r, ref.mesh_shape)
            # no port hook: the identity (gossip leaves the gradient)
            mine = got[r].get(label, cases.own_grads(spec, r))
            assert (label in got[r]) == (label in threaded[r])
            for k in g:
                if label in got[r]:
                    assert _equal(mine[k], threaded[r][label][k])
                np.testing.assert_allclose(
                    mine[k].numpy(), np.asarray(want[k])[at],
                    atol=1e-6, rtol=1e-6, err_msg=f"{label} {k} rank {r}")


def test_shard_gather_and_metrics_over_processes(ranks):
    group = PositionGroup(4)
    try:
        threaded = group.run(lambda r: group.shard_gather(
            r, cases.MEMBERS)(cases.chunks(r)))
    finally:
        group.close()
    for r, res in enumerate(ranks[4]):
        assert all(_equal(a, b) for a, b in zip(res["shard_gather"],
                                                threaded[r]))
        assert [m[0, 0].item() for m in res["metrics"]] == [
            0.5, 1.5, 2.5, 3.5]


# ----------------------------------------------------------- (b) fits
@pytest.mark.parametrize("name", list(cases.FITS))
def test_fit_over_processes_is_bitwise_the_threaded_fit(ranks, name):
    W = cases.config(name).plan.sim_devices
    with one_thread():
        want, whist = cases.fit(name)
    for r, res in enumerate(ranks[W]):
        state, hist = res["fits"][name]
        _same_state(state, want)       # position 0's state on every rank
        assert json.dumps(hist) == json.dumps(whist), r
    if name == "dqn_replay":
        assert want.extra["replay"]["prio"].shape == (256,)


def test_a_group_of_another_size_is_refused():
    """One process a position: a group of 2 ranks for 4 positions."""
    import types
    import repro_torch.envs as envs
    from repro_torch.core.trainer import Trainer
    with pytest.raises(ValueError, match="2 ranks for the plan's 4 data"):
        Trainer(envs.make("cartpole"), cases.config("impala_flat4"),
                device="cpu", positions=types.SimpleNamespace(n=2, rank=0))


# -------------------------------------------------------- (c) no hang
def test_a_rank_that_raises_stops_the_run_naming_it():
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match=r"(?s)rank 1 of 2 failed.*"
                                         r"injected failure at iteration 2"):
        spawn(cases.fail_at, (1, 2), 2, timeout=60)
    assert time.monotonic() - t0 < 60
    assert not multiprocessing.active_children()


def test_a_rank_that_skips_a_collective_times_the_others_out():
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="rank 0 of 2 failed"):
        spawn(cases.skip_collective, (1,), 2, timeout=3)
    assert time.monotonic() - t0 < 40
    assert not multiprocessing.active_children()


def test_a_run_past_its_deadline_is_killed():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] of 2 did not "
                                           r"finish within 2 s"):
        spawn(cases.sleep_for, (60,), 2, deadline=2)
    assert time.monotonic() - t0 < 30
    assert not multiprocessing.active_children()


# ------------------------------------------------------------ (d) CLI
CLI = ["--algo", "impala", "--env", "cartpole", "--n-workers", "4",
       "--iters", "4", "--superstep", "2", "--n-envs", "8", "--unroll", "8",
       "--log-every", "1", "--device", "cpu"]


def test_gloo_cli_prints_the_positions_line(capsys):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.rl_train", *CLI,
         "--backend", "gloo"], env=env, capture_output=True, text=True,
        timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    with one_thread():
        rl_train.main(CLI)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.pop("backend") == "gloo" and got.pop("n_processes") == 4
    got.pop("wall_s"), want.pop("wall_s")
    assert json.dumps(got) == json.dumps(want)


def test_nccl_without_a_card_a_rank_refuses_before_spawning(capsys):
    with pytest.raises(SystemExit) as exc:
        rl_train.main(CLI[:-2] + ["--backend", "nccl"])
    assert exc.value.code == 2
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert f"4 ranks, {cards} card" in capsys.readouterr().err
    assert not multiprocessing.active_children()
