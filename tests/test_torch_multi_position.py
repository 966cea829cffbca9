"""Several data positions on one device (repro_torch.core.{positions,
topology,distribution,trainer}) on the CPU, against the JAX package under
`jax.vmap` named axes, the stand-in for its mesh that
tests/test_torch_replay_service.py uses:

  (a) the collectives: `exchange_grads` (allreduce, ps, gossip) and
      `gossip_mix` (1-3 hops) at W = 2, 4, 8, and the hooks of
      `compile_collectives` for flat(4) and grid(2, 2) with every
      inter-host collective, under nested vmap; within 1e-6;
  (b) `linear_index` / `sim_index` against `jax.lax.axis_index` under
      nested vmap, with and without a replay axis;
  (c) one learner step per algorithm under the collectives: in
      tests/test_torch_multi_position_step.py;
  (d) the Trainer: flat(4), (hosts=1, workers=4) and grid(2, 2) fits
      bitwise equal, fused equal to unfused at W = 4, every position's
      params equal under allreduce and ps, ps within rel 1e-3 of
      allreduce, and the collective x sync matrix finite and learning;
  (e) elastic schedules: which envs each position keeps on a shrink and
      how many fresh envs a grow resets, against the reference's
      `_reshard_envs` on the same layout; `actor_shards` follows the
      schedule;
  (f) dqn under workers=2, replay=2: bitwise the flat two-worker fit,
      and the returned buffer flat;
  (g) no hang: a position that raises makes `fit` raise that error at
      once, a collective that waits too long raises TimeoutError, and
      one that a position skips raises.
"""
import json
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jax_topology
from repro.core.distribution import DistPlan as JaxPlan
from repro.core.trainer import Trainer as JaxTrainer
import repro_torch.envs as envs
from repro_torch.core import topology
from repro_torch.core.distribution import AxisSpec, DistPlan
from repro_torch.core.positions import (PositionGroup, tree_leaves,
                                         tree_map)
from repro_torch.core.trainer import Trainer, TrainerConfig, stream_seed

COLL_TOL = dict(atol=1e-6, rtol=1e-6)


def _grads(lead, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(lead + (3, 4)).astype(np.float32),
            "b": rng.standard_normal(lead + (5,)).astype(np.float32)}


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _close(port, ref, tol=COLL_TOL):
    for k in ref:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   **tol, err_msg=k)


# ------------------------------------------------------ (a) collectives
@pytest.mark.parametrize("W", [2, 4, 8])
@pytest.mark.parametrize("topo", ["allreduce", "ps", "gossip"])
def test_exchange_grads_matches_jax(W, topo):
    g = _grads((W,), seed=W)
    want = jax.vmap(lambda x: jax_topology.exchange_grads(x, "w", topo),
                    axis_name="w")({k: jnp.asarray(v) for k, v in g.items()})
    _close(topology.exchange_grads(_t(g), topo), want)


@pytest.mark.parametrize("W", [2, 4, 8])
@pytest.mark.parametrize("hops", [1, 2, 3])
def test_gossip_mix_matches_jax(W, hops):
    p = _grads((W,), seed=10 * W + hops)
    want = jax.vmap(lambda x: jax_topology.gossip_mix(x, "w", hops),
                    axis_name="w")({k: jnp.asarray(v) for k, v in p.items()})
    _close(topology.gossip_mix(_t(p), 0, hops), want)


def _nested(fn, names):
    """`fn` under one vmap per mesh axis, outermost first."""
    for name in reversed(names):
        fn = jax.vmap(fn, axis_name=name)
    return fn


@pytest.mark.parametrize("spec", [
    "workers=4:allreduce:bsp", "workers=4:ps:bsp", "workers=4:gossip:bsp",
    "hosts=2:allreduce:bsp,workers=2:allreduce:bsp",
    "hosts=2:ps:bsp,workers=2:allreduce:bsp",
    "hosts=2:gossip:bsp,workers=2:allreduce:bsp",
    "hosts=2:allreduce:bsp,workers=2:gossip:bsp",
    "hosts=2:ps:bsp,workers=2:ps:bsp"])
def test_compile_collectives_match_jax(spec):
    plan, ref = DistPlan.parse(spec), JaxPlan.parse(spec)
    g = _grads(plan.mesh_shape, seed=len(spec))
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    grad_tx, param_tx = plan.compile_collectives()
    jgrad_tx, jparam_tx = ref.compile_collectives()
    want = _nested(jgrad_tx, ref.axis_names)(jg)
    _close(_t(g) if grad_tx is None else grad_tx(_t(g)), want)
    assert (param_tx is None) == (jparam_tx is None)
    if param_tx is not None:
        _close(param_tx(_t(g)), _nested(jparam_tx, ref.axis_names)(jg))


def test_allreduce_nestings_reduce_bitwise_alike():
    """flat(4), (1, 4) and (2, 2) sum the same members in the same order."""
    g = _grads((4,), seed=3)
    flat = DistPlan.flat(4).compile_collectives()[0](_t(g))
    for spec, lead in (("hosts=1,workers=4", (1, 4)),
                       ("hosts=2,workers=2", (2, 2))):
        nested = DistPlan.parse(spec).compile_collectives()[0](
            {k: v.reshape(lead + v.shape[1:]) for k, v in _t(g).items()})
        for k in flat:
            assert torch.equal(nested[k].reshape(flat[k].shape), flat[k])


# ---------------------------------------------------------- (b) indices
@pytest.mark.parametrize("spec", [
    "workers=4", "hosts=2,workers=3", "hosts=1,workers=4",
    "workers=2,replay=2:allreduce:bsp:replay",
    "hosts=2,replay=2:allreduce:bsp:replay,workers=2",
    "workers=1,replay=4:allreduce:bsp:replay",
    "workers=2,replay=1:allreduce:bsp:replay"])
def test_indices_match_axis_index(spec):
    plan, ref = DistPlan.parse(spec), JaxPlan.parse(spec)
    zeros = jnp.zeros(plan.mesh_shape)
    lin = np.asarray(_nested(lambda _: ref.linear_index(),
                             ref.axis_names)(zeros))
    sim = np.asarray(_nested(lambda _: ref.sim_index(),
                             ref.axis_names)(zeros))
    for coords in np.ndindex(*plan.mesh_shape):
        assert plan.linear_index(coords) == lin[coords]
        assert plan.sim_index(coords) == sim[coords]
    # the env grid's positions, in rank order, are sim_index 0, 1, ...
    assert [plan.sim_index(c) for c in plan.sim_coords()] == list(
        range(plan.sim_devices))


# ---------------------------------------------------------- (d) Trainer
ENV = envs.make("cartpole")


def _cfg(plan, algo="impala", **kw):
    return TrainerConfig(algo=algo, iters=6, superstep=3, n_envs=8,
                         unroll=8, plan=plan, log_every=1, seed=0,
                         algo_kwargs={"hidden": (8,)}, **kw)


def _fit(plan, fused=True, **kw):
    return Trainer(ENV, _cfg(plan, **kw), device="cpu").fit(fused=fused)


def _bitwise(a, b):
    return all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def test_flat_and_nested_allreduce_fits_bitwise():
    s_flat, h_flat = _fit(DistPlan.flat(4))
    s_14, h_14 = _fit(DistPlan(axes=(AxisSpec("hosts", 1),
                                     AxisSpec("workers", 4))))
    s_22, h_22 = _fit(DistPlan.grid(2, 2))
    assert _bitwise(s_flat, s_14) and _bitwise(s_flat, s_22)
    # json.dumps spells NaN alike: NaN-aware equality of the histories
    assert json.dumps(h_flat) == json.dumps(h_14) == json.dumps(h_22)


def test_fused_equals_unfused_at_four_positions():
    a, ha = _fit(DistPlan.grid(2, 2, intra="ps", intra_sync="asp",
                               max_delay=2))
    b, hb = _fit(DistPlan.grid(2, 2, intra="ps", intra_sync="asp",
                               max_delay=2), fused=False)
    assert _bitwise(a, b) and json.dumps(ha) == json.dumps(hb)


def _positions(plan, algo="impala"):
    """Every position's final state of a fit, and the history."""
    tr = Trainer(ENV, _cfg(plan, algo), device="cpu")
    seen = {}
    run = tr._run
    tr._run = lambda states, *a: seen.setdefault("s", states) and run(
        states, *a)
    _, hist = tr.fit()
    return seen["s"], hist


@pytest.mark.parametrize("topo", ["allreduce", "ps"])
def test_positions_stay_identical_under_exchanged_gradients(topo):
    states, _ = _positions(DistPlan.flat(4, collective=topo))
    assert len(states) == 4
    assert all(_bitwise(states[0], s) for s in states[1:])
    gossip, _ = _positions(DistPlan.flat(4, collective="gossip"))
    assert not all(_bitwise(gossip[0], s) for s in gossip[1:])


def test_ps_agrees_with_allreduce():
    _, ha = _fit(DistPlan.flat(4, collective="allreduce"))
    _, hp = _fit(DistPlan.flat(4, collective="ps"))
    assert hp[-1]["loss"] == pytest.approx(ha[-1]["loss"], rel=1e-3)


@pytest.mark.parametrize("coll", ["allreduce", "ps", "gossip"])
@pytest.mark.parametrize("sync", ["bsp", "asp", "ssp"])
def test_collective_sync_matrix_trains(coll, sync):
    """The reference's _MATRIX_SCRIPT: finite losses, a real return."""
    _, hist = _fit(DistPlan.flat(4, collective=coll, sync=sync,
                                 max_delay=2))
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert np.isfinite(hist[-1]["episode_return"])
    assert hist[-1]["episode_return"] > 0


def test_positions_act_with_their_own_delays_and_streams():
    plan = DistPlan.grid(2, 2, inter_sync="asp", intra_sync="ssp",
                         max_delay=3)
    tr = Trainer(ENV, _cfg(plan), device="cpu")
    states, sims, delays = tr._init_all()
    gen = torch.Generator().manual_seed(stream_seed(0, -1, 4))  # _DELAY
    schedule = plan.make_delay_schedule(6, gen)
    for r, (h, w) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        assert delays[r] == schedule[:, h, w].tolist()
    assert len({tuple(d) for d in delays}) > 1
    seeds = {tr._generator(3, 0, r).initial_seed() for r in range(4)}
    assert len(seeds) == 4
    # position r holds envs [2r, 2r + 2) of the one reset
    full = ENV.reset(torch.Generator().manual_seed(stream_seed(0, -1, 3)),
                     8)                                         # _ENV
    for r in range(4):
        assert torch.equal(sims[r]["env"]["s"], full["s"][2 * r:2 * r + 2])


# ------------------------------------------------------- (e) elastic
class _IdEnv:
    """Envs that are their ids: a reset of n hands out the next n ids."""

    def __init__(self, torch_side):
        self.torch_side = torch_side
        self.resets = []

    def _fresh(self, n):
        self.resets.append(n)
        base = 1000 * len(self.resets)
        return base + np.arange(n)

    def reset(self, generator, n):
        return {"id": torch.tensor(self._fresh(n))}

    def reset_batch(self, key, n):
        return {"id": jnp.asarray(self._fresh(n))}


@pytest.mark.parametrize("spec,W", [("workers=4", 4),
                                    ("hosts=2,workers=2", 4),
                                    ("workers=1", 1)])
@pytest.mark.parametrize("path", [(8, 4), (8, 16), (8, 16, 4, 12)])
def test_reshard_matches_the_reference(spec, W, path):
    plan, ref = DistPlan.parse(spec), JaxPlan.parse(spec)
    n0, per = path[0], path[0] // W
    # the reference's layout: one leading dim per mesh axis
    jenv, penv = _IdEnv(False), _IdEnv(True)
    ns = types.SimpleNamespace(mesh=None if W == 1 else object(), plan=ref,
                               env=jenv)
    ns._shard_sim = lambda sim: JaxTrainer._shard_sim(ns, sim)
    lead = ref.mesh_shape if W > 1 else ()
    ids = np.arange(n0)
    jsim = {"env": {"id": jnp.asarray(ids.reshape(lead + (per,)))},
            "ep_run": jnp.asarray((ids + 0.5).reshape(lead + (per,)),
                                  jnp.float32),
            "ep_last": jnp.zeros(lead)}
    tr = Trainer(ENV, TrainerConfig(algo="impala", n_envs=n0, plan=plan,
                                    algo_kwargs={"hidden": (8,)}),
                 device="cpu")
    tr.env = penv
    sims = [{"env": {"id": torch.tensor(ids[r * per:(r + 1) * per])},
             "ep_run": torch.tensor(ids[r * per:(r + 1) * per] + 0.5,
                                    dtype=torch.float32),
             "ep_last": torch.zeros(())} for r in range(W)]
    for s_idx, n in enumerate(path[1:]):
        jsim = JaxTrainer._reshard_envs(ns, jsim, n, jax.random.PRNGKey(0))
        sims = tr._reshard_envs(sims, n, s_idx)
        want = np.asarray(jsim["env"]["id"]).reshape(W, -1)
        want_run = np.asarray(jsim["ep_run"]).reshape(W, -1)
        for r in range(W):
            np.testing.assert_array_equal(sims[r]["env"]["id"].numpy(),
                                          want[r])
            np.testing.assert_array_equal(sims[r]["ep_run"].numpy(),
                                          want_run[r])
    assert penv.resets == jenv.resets


def test_actor_shards_follow_the_schedule():
    plan = DistPlan.flat(4, actors=(8, 16, 4))
    cfg = TrainerConfig(algo="a3c", iters=8, superstep=2, n_envs=8,
                        unroll=4, plan=plan, log_every=1,
                        algo_kwargs={"hidden": (8,)})
    tr = Trainer(ENV, cfg, device="cpu")
    _, hist = tr.fit()
    assert tr.actor_shards == [8, 16, 4, 8]
    assert all(np.isfinite(h["loss"]) for h in hist)
    # unfused reshards at the same iterations: the same numbers
    tr2 = Trainer(ENV, cfg, device="cpu")
    _, hist2 = tr2.fit(fused=False)
    assert json.dumps(hist) == json.dumps(hist2)
    assert tr2.actor_shards == [8, 8, 16, 16, 4, 4, 8, 8]


def test_indivisible_schedules_raise_as_the_reference():
    with pytest.raises(ValueError, match="simulation devices"):
        Trainer(ENV, TrainerConfig(n_envs=6, plan=DistPlan.flat(4)),
                device="cpu")
    with pytest.raises(ValueError, match=r"actors= schedule entries \[6\]"):
        Trainer(ENV, TrainerConfig(n_envs=8, plan=DistPlan.flat(
            4, actors=(8, 6))), device="cpu")


# -------------------------------------------- (f) replay under positions
def test_dqn_replay_groups_under_two_positions():
    kw = dict(algo="dqn", iters=6, superstep=3, n_envs=8, unroll=4,
              log_every=1, algo_kwargs={"hidden": (8,), "warmup": 2,
                                        "replay_capacity": 256,
                                        "batch_size": 16})
    tr = Trainer(ENV, TrainerConfig(plan=DistPlan.replay(2, 2), **kw),
                 device="cpu")
    state, hist = tr.fit()
    flat, hflat = Trainer(ENV, TrainerConfig(plan=DistPlan.flat(2), **kw),
                          device="cpu").fit()
    assert tr.n_positions == 2 and tr.partition_replay["n_shards"] == 2
    assert state.extra["replay"]["prio"].shape == (256,)
    assert _bitwise(state, flat) and json.dumps(hist) == json.dumps(hflat)
    for a, b in zip(tree_leaves(state.extra["replay"]),
                    tree_leaves(flat.extra["replay"])):
        assert torch.equal(a, b)


# -------------------------------------------------------- (g) no hang
def test_a_failing_position_raises_at_once():
    tr = Trainer(ENV, _cfg(DistPlan.flat(4)), device="cpu")
    step = tr._agents[2].learner_step
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise ArithmeticError("position 2 failed mid-fit")
        return step(*a, **k)

    tr._agents[2].learner_step = flaky
    t0 = time.perf_counter()
    with pytest.raises(ArithmeticError, match="position 2 failed"):
        tr.fit()
    assert time.perf_counter() - t0 < 10


def test_a_collective_that_waits_too_long_times_out():
    group = PositionGroup(2, timeout=0.3)
    hook = [group.hook(r, lambda x: x, (2,)) for r in range(2)]

    def work(r):
        if r == 1:
            time.sleep(1.0)    # holds the turn past rank 0's timeout
        return hook[r]({"g": torch.ones(3)})

    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        group.run(work)
    group.close()
    assert time.perf_counter() - t0 < 10


def test_a_collective_one_position_skips_raises():
    group = PositionGroup(2, timeout=30.0)
    hook = group.hook(0, lambda x: x, (2,))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="same collective calls"):
        group.run(lambda r: hook({"g": torch.ones(3)}) if r == 0 else None)
    group.close()
    assert time.perf_counter() - t0 < 10


def test_a_collective_hands_each_rank_its_row():
    group = PositionGroup(3)
    hooks = [group.hook(r, lambda t: tree_map(lambda x: x * 2, t), (3,))
             for r in range(3)]
    out = group.run(lambda r: hooks[r]({"a": torch.full((2,), float(r)),
                                        "b": torch.full((1, 2), -float(r))}))
    group.close()
    for r, o in enumerate(out):
        assert torch.equal(o["a"], torch.full((2,), 2.0 * r))
        assert torch.equal(o["b"], torch.full((1, 2), -2.0 * r))
    assert threading.active_count() < 50


def test_several_positions_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(ENV, TrainerConfig(plan=DistPlan.flat(4)))
