"""The decoupled actor–learner pipeline in the port (repro_torch.core.
pipeline and the Trainer's ``pipeline=`` mode) on the CPU:

  (a) the queue ops against repro.core.pipeline on the same push/pop
      sequences (init shapes, the capacity-1 round trip, wraparound past
      capacity, push on full, pop on empty, the bad capacity's message);
  (b) no aliasing: the item consumed at iteration t is the one produced
      for t, `depth` ticks earlier, unchanged since;
  (c) the Trainer's depth and capacity, and the refusals, against the
      reference's Trainer;
  (d) fits: depth 0 is the fused fit bitwise under flat(1) and flat(4),
      chunking a depth-1 fit changes nothing for all four algorithms
      (bitwise, where the reference reaches allclose for ppo and fails
      for dqn), ssp depth 1 and asp depth 4 train finite, ZeRO-2 under
      the pipeline is bitwise the flat pipelined fit;
  (e) HostPipelined stays unregistered and queue-free and gives the
      on-device env's history exactly under the pipeline;
  (f) the CLI's `--pipeline` line.
"""
import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as jenvs
from repro.core import pipeline as jax_pipeline
from repro.core.distribution import DistPlan as JaxPlan
from repro.core.trainer import Trainer as JaxTrainer
from repro.core.trainer import TrainerConfig as JaxConfig
import repro_torch.envs as envs
from repro_torch.core import pipeline
from repro_torch.core.distribution import DistPlan
from repro_torch.core.positions import tree_leaves
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.envs.host_env import HostPipelined
from repro_torch.launch import rl_train

ALGOS = ("a3c", "dqn", "impala", "ppo")
SSP1 = dict(sync="ssp", staleness_bound=1, max_delay=1)


def _jitem(i):
    return {"x": jnp.full((3, 2), float(i)), "n": jnp.asarray(i, jnp.int32)}


def _titem(i):
    return {"x": torch.full((3, 2), float(i)),
            "n": torch.tensor(i, dtype=torch.int32)}


# ------------------------------------------------------ (a) queue ops
def test_queue_init_shapes_match_the_reference():
    jq = jax_pipeline.queue_init(_jitem(0), 4)
    q = pipeline.queue_init(_titem(5), 4)
    assert pipeline.queue_capacity(q) == jax_pipeline.queue_capacity(jq)
    assert pipeline.queue_size(q) == int(jax_pipeline.queue_size(jq)) == 0
    for slot in range(4):
        for k in ("x", "n"):
            want = np.asarray(jq["buf"][k][slot])
            got = q["buf"][slot][k]
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.numpy(), want)  # zeros
    assert q["buf"][0]["n"].dtype == torch.int32


def test_queue_bad_capacity_raises_the_references_message():
    with pytest.raises(ValueError) as p:
        pipeline.queue_init(_titem(0), 0)
    with pytest.raises(ValueError) as r:
        jax_pipeline.queue_init(_jitem(0), 0)
    assert str(p.value) == str(r.value)


def _replay(ops, cap):
    """Run the same push/pop sequence through both packages: per op,
    (ok, size, popped n or None) from each."""
    jq = jax_pipeline.queue_init(_jitem(0), cap)
    q = pipeline.queue_init(_titem(0), cap)
    out = []
    for op in ops:
        if op == "pop":
            jq, jit, jok = jax_pipeline.queue_pop(jq)
            q, it, ok = pipeline.queue_pop(q)
            out.append(((bool(jok), int(jax_pipeline.queue_size(jq)),
                         int(jit["n"])),
                        (ok, pipeline.queue_size(q), int(it["n"]))))
        else:
            jq, jok = jax_pipeline.queue_push(jq, _jitem(op))
            q, ok = pipeline.queue_push(q, _titem(op))
            out.append(((bool(jok), int(jax_pipeline.queue_size(jq)), None),
                        (ok, pipeline.queue_size(q), None)))
    assert (int(jq["head"]), int(jq["tail"])) == (q["head"], q["tail"])
    return out


@pytest.mark.parametrize("cap,ops", [
    # capacity 1: round trip, push on full refused, pop on empty stale
    (1, [7, 8, "pop", "pop", 9, "pop"]),
    # wraparound: six pushes through a two-slot ring stay FIFO
    (2, [0, 1, "pop", 2, "pop", 3, "pop", 4, "pop", 5, "pop", "pop",
         "pop"]),
    # depth 3 in steady state, pop first then push (the tick's order)
    (3, [0, 1, 2] + [x for i in range(3, 9) for x in ("pop", i)])])
def test_queue_ops_match_the_reference(cap, ops):
    for want, got in _replay(ops, cap):
        assert got == want


def test_queue_push_keeps_references_and_writes_nothing_in_place():
    item = _titem(3)
    q0 = pipeline.queue_init(item, 1)
    q1, ok = pipeline.queue_push(q0, item)
    assert ok and q1["buf"][0] is item          # the pushed tree itself
    assert q0["buf"][0] is not item             # the old queue unchanged
    q2, popped, ok = pipeline.queue_pop(q1)
    q3, _ = pipeline.queue_push(q2, _titem(4))
    assert popped is item and int(popped["n"]) == 3
    assert int(q3["buf"][0]["n"]) == 4


# ------------------------------------------------------ (b) aliasing
@pytest.mark.parametrize("plan,depth", [
    (DistPlan.flat(1, **SSP1), 1),
    (DistPlan.flat(1, sync="asp", max_delay=3), 3),
    (DistPlan.flat(2, **SSP1), 1)])
def test_consumed_item_is_the_one_produced_depth_ticks_earlier(plan, depth):
    cfg = TrainerConfig(algo="impala", iters=6, superstep=4, n_envs=4,
                        unroll=4, plan=plan, pipeline=True,
                        algo_kwargs={"hidden": (8,)})
    tr = Trainer(envs.make("cartpole"), cfg, device="cpu")
    assert (tr.pipeline_depth, tr.pipeline_capacity) == (depth, depth)
    events = []       # (kind, rank, iteration, item, copy at production)
    produce, consume = tr._produce, tr._consume

    def spy_produce(state, env_state, it, delay=None, rank=0):
        item, env_state = produce(state, env_state, it, delay, rank)
        events.append(("produce", rank, it, item,
                       {k: v.clone() for k, v in item["traj"].items()}))
        return item, env_state

    def spy_consume(state, ep_run, ep_last, item, it, rank=0):
        events.append(("consume", rank, it, item, None))
        return consume(state, ep_run, ep_last, item, it, rank)

    tr._produce, tr._consume = spy_produce, spy_consume
    tr.fit()
    for rank in range(tr.n_positions):
        mine = [e for e in events if e[1] == rank]
        produced = {e[2]: (i, e[3], e[4]) for i, e in enumerate(mine)
                    if e[0] == "produce"}
        consumed = [(i, e[2], e[3]) for i, e in enumerate(mine)
                    if e[0] == "consume"]
        # the producer over-runs the fit by `depth` iterations
        assert sorted(produced) == list(range(cfg.iters + depth))
        assert [it for _, it, _ in consumed] == list(range(cfg.iters))
        for _, it, item in consumed:
            at, made, snapshot = produced[it]
            assert item is made
            for k, v in snapshot.items():
                assert torch.equal(item["traj"][k], v), (it, k)
            # produced in the tick of iteration it - depth: after the
            # consumption of it - depth - 1, before that of it - depth
            # (the first `depth` in the prologue, before any)
            when = {i2: p for p, i2, _ in consumed}
            assert at < when[max(it - depth, 0)]
            if it - depth - 1 >= 0:
                assert at > when[it - depth - 1]


# --------------------------------------------- (c) depth and refusals
@pytest.mark.parametrize("plan,pipe", [
    (JaxPlan.flat(1), True), (JaxPlan.flat(1, **SSP1), True),
    (JaxPlan.flat(1, sync="asp", max_delay=4), True),
    (JaxPlan.flat(1, sync="ssp", staleness_bound=2, max_delay=4), True),
    (JaxPlan.flat(1, **SSP1), False)])
def test_trainer_depth_and_capacity_match_the_reference(plan, pipe):
    kw = dict(algo="impala", n_envs=8, pipeline=pipe,
              algo_kwargs={"hidden": (8,)})
    ref = JaxTrainer(jenvs.make("cartpole"), JaxConfig(plan=plan, **kw))
    port = Trainer(envs.make("cartpole"), TrainerConfig(
        plan=DistPlan.parse(plan.describe(), max_delay=plan.axes[0].max_delay,
                            staleness_bound=plan.axes[0].staleness_bound),
        **kw), device="cpu")
    assert (port.pipeline_depth, port.pipeline_capacity) == (
        ref.pipeline_depth, ref.pipeline_capacity)


def _same_error(build_port, build_ref):
    with pytest.raises(ValueError) as p:
        build_port()
    with pytest.raises(ValueError) as r:
        build_ref()
    assert str(p.value) == str(r.value)
    return str(p.value)


@pytest.mark.parametrize("spec,actors,algo,frag", [
    ("workers=1:allreduce:bsp", (8, 16), "impala", "varying elastic"),
    ("workers=2:allreduce:bsp,shard=2:allreduce:bsp:zero3", None, "impala",
     "zero3-role axis 'shard'"),
    ("workers=1:allreduce:bsp,replay=2:allreduce:bsp:replay", None, "dqn",
     "replay-role axis 'replay'")])
def test_pipeline_refusals_are_the_references(spec, actors, algo, frag):
    kw = dict(algo=algo, n_envs=8, pipeline=True,
              algo_kwargs={"hidden": (8,)})
    msg = _same_error(
        lambda: Trainer(envs.make("cartpole"), TrainerConfig(
            plan=DistPlan.parse(spec, actors=actors), **kw), device="cpu"),
        lambda: JaxTrainer(jenvs.make("cartpole"), JaxConfig(
            plan=JaxPlan.parse(spec, actors=actors), **kw)))
    assert frag in msg and "pipeline=True" in msg


def test_constant_actor_schedule_runs_pipelined():
    cfg = TrainerConfig(algo="impala", iters=4, superstep=2, n_envs=8,
                        unroll=4, plan=DistPlan.flat(1, actors=(4, 4), **SSP1),
                        pipeline=True, log_every=1,
                        algo_kwargs={"hidden": (8,)})
    tr = Trainer(envs.make("cartpole"), cfg, device="cpu")
    _, hist = tr.fit()
    assert tr.actor_shards == [4, 4] and len(hist) == 4
    assert all(np.isfinite(h["loss"]) for h in hist)


# ------------------------------------------------------------ (d) fits
def _eq(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def _fit(algo, plan, pipeline, superstep=2, iters=4, env=None):
    kw = {"hidden": (8,)}
    if algo == "dqn":
        kw.update(replay_capacity=256, warmup=1)
    cfg = TrainerConfig(algo=algo, iters=iters, superstep=superstep,
                        n_envs=8, unroll=6, plan=plan, log_every=1,
                        pipeline=pipeline, algo_kwargs=kw)
    tr = Trainer(env or envs.make("cartpole"), cfg, device="cpu")
    state, hist = tr.fit()
    return tr, state, hist


def _assert_bitwise(a, ha, b, hb):
    for part in ("params", "opt_state", "extra", "ring", "steps"):
        assert _eq(getattr(a, part), getattr(b, part)), part
    assert json.dumps(ha) == json.dumps(hb)   # NaN before the first return


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("algo", ALGOS)
def test_depth0_is_the_fused_fit_bitwise(algo, W):
    _, a, ha = _fit(algo, DistPlan.flat(W), pipeline=False)
    tr, b, hb = _fit(algo, DistPlan.flat(W), pipeline=True)
    assert (tr.pipeline_depth, tr.pipeline_capacity) == (0, 1)
    _assert_bitwise(a, ha, b, hb)


@pytest.mark.parametrize("algo", ALGOS)
def test_chunked_depth1_fit_is_the_one_shot_fit_bitwise(algo):
    plan = DistPlan.flat(1, **SSP1)
    tr, a, ha = _fit(algo, plan, pipeline=True, superstep=2)
    assert tr.pipeline_depth == 1
    _, b, hb = _fit(algo, plan, pipeline=True, superstep=4)
    _assert_bitwise(a, ha, b, hb)


@pytest.mark.parametrize("algo,plan,depth", [
    ("ppo", DistPlan.flat(4, **SSP1), 1), ("dqn", DistPlan.flat(4, **SSP1),
                                           1),
    ("a3c", DistPlan.flat(1, sync="asp", max_delay=4), 4),
    ("impala", DistPlan.grid(2, 2, inter_sync="ssp", intra_sync="ssp",
                             staleness_bound=1), 2)])
def test_deeper_pipelines_train_finite(algo, plan, depth):
    tr, state, hist = _fit(algo, plan, pipeline=True, iters=6)
    assert tr.pipeline_depth == depth and tr.pipeline_capacity == depth
    assert len(hist) == 6 and all(np.isfinite(h["loss"]) for h in hist)
    assert int(state.steps) == 6


def test_zero2_under_the_pipeline_is_the_flat_pipelined_fit():
    _, a, ha = _fit("impala", DistPlan.flat(4, **SSP1), pipeline=True)
    tr, b, hb = _fit("impala", DistPlan.zero(2, 2, **SSP1), pipeline=True)
    assert tr.pipeline_depth == 1 and tr.partition["n_shards"] == 2
    _assert_bitwise(a, ha, b, hb)


# ------------------------------------------------------ (e) HostPipelined
def test_host_pipelined_stays_unregistered_and_queue_free():
    assert not any("host" in name for name in envs.available())
    env = HostPipelined(envs.make("cartpole"))
    assert not hasattr(env, "queue") and not hasattr(env, "prefetch")


def test_host_pipelined_gives_the_on_device_history_exactly():
    plan = DistPlan.flat(1, **SSP1)
    _, a, ha = _fit("impala", plan, True, iters=3)
    _, b, hb = _fit("impala", plan, True, iters=3,
                    env=HostPipelined(envs.make("cartpole")))
    _assert_bitwise(a, ha, b, hb)


# ------------------------------------------------------------ (f) CLI
def test_cli_pipeline_reports_depth_and_capacity():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rl_train.main(["--device", "cpu", "--algo", "dqn", "--plan",
                       "workers=2:allreduce:ssp", "--staleness-bound", "1",
                       "--pipeline", "--iters", "4", "--superstep", "2",
                       "--n-envs", "8", "--unroll", "4", "--log-every",
                       "2"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["pipeline"] is True and out["pipeline_depth"] == 1
    assert out["pipeline_capacity"] == 1 and out["partition"] is None
    assert out["history"] and all(np.isfinite(h["loss"])
                                  for h in out["history"])
