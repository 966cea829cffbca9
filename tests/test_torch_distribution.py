"""The port's distribution plans (repro_torch.core.{distribution,sync,
topology}), the Trainer's plan mode and `rl_train --plan` / `--sync` on
the CPU, against the JAX package where it has a counterpart:

  (a) the plan grammar, constructors, derived shapes, `ring_extra` and
      the `describe` round trip: the port's plan describes itself as the
      reference's plan of the same spec does, and every validation error
      carries the reference's message verbatim. The reference's
      hypothesis round trips (tests/test_distribution.py) become seeded
      loops over random plans here;
  (b) the delay schedules: a torch.Generator cannot replay JAX's threefry
      draws, so the laws of tests/test_sync_topology.py hold instead (bsp
      zeros, asp in [0, max_delay], ssp no greater than its bound),
      additive across axes, a single-axis plan drawing what
      `make_delays` draws;
  (c) the stacked collectives against JAX's `all_gather_shards`,
      `local_shard` and `psum_select` under vmap named axes, bitwise;
  (d) the Trainer's plan mode: the delay schedule feeds `actor_policy`,
      plans with several data positions, replay groups under them and an
      elastic schedule run, and the shard/zero3 roles are refused by name
      with their slice;
  (e) the CLI: `--plan` with a replay axis prints `partition_replay`,
      `--sync asp|ssp` trains one worker, several data positions train,
      and a shard axis larger than 1 is refused by name.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sync as jax_sync
from repro.core import topology as jax_topology
from repro.core.distribution import AxisSpec as JaxAxis
from repro.core.distribution import DistPlan as JaxPlan
import repro_torch.envs as envs
from repro_torch.core import sync, topology
from repro_torch.core.distribution import ROLES, AxisSpec, DistPlan
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.launch import rl_train


def _same_plan(port, ref):
    """The port's plan and the reference's carry the same axes."""
    assert port.describe() == ref.describe()
    assert port.axis_names == ref.axis_names
    assert port.mesh_shape == ref.mesh_shape
    for a, b in zip(port.axes, ref.axes):
        assert (a.name, a.size, a.collective, a.sync, a.max_delay,
                a.staleness_bound, a.role) == (
                    b.name, b.size, b.collective, b.sync, b.max_delay,
                    b.staleness_bound, b.role)
    assert port.actors == ref.actors
    for prop in ("n_devices", "ring_extra", "pipeline_depth", "shard_size",
                 "replay_size", "sim_shape", "sim_devices"):
        assert getattr(port, prop) == getattr(ref, prop), prop


def _same_error(build_port, build_ref):
    """Both raise ValueError with the same message; returns it."""
    with pytest.raises(ValueError) as p:
        build_port()
    with pytest.raises(ValueError) as r:
        build_ref()
    assert str(p.value) == str(r.value)
    return str(p.value)


# ----------------------------------------------------- (a) the grammar
def test_plan_defaults_to_flat_single_worker():
    plan = DistPlan.flat()
    assert plan.axis_names == ("workers",)
    assert plan.mesh_shape == (1,)
    assert plan.n_devices == 1 and plan.ring_extra == 0
    assert plan.shard_axis is None and plan.shard_size == 1
    assert plan.replay_axis is None and plan.replay_size == 1
    assert ROLES == ("data", "shard", "zero3", "replay")


def test_plan_parse_round_trip():
    s = "hosts=2:allreduce:bsp,workers=4:gossip:asp"
    plan = DistPlan.parse(s, max_delay=3)
    assert plan.axis_names == ("hosts", "workers")
    assert plan.mesh_shape == (2, 4)
    assert plan.axes[1].collective == "gossip"
    assert plan.axes[1].sync == "asp"
    assert plan.describe() == s
    assert plan.ring_extra == 3  # bsp(0) + asp(max_delay=3)
    _same_plan(plan, JaxPlan.parse(s, max_delay=3))


def test_plan_ring_extra_adds_across_axes():
    plan = DistPlan(axes=(
        AxisSpec("hosts", 2, sync="asp", max_delay=5),
        AxisSpec("workers", 2, sync="ssp", max_delay=5,
                 staleness_bound=2)))
    assert plan.ring_extra == 5 + 2
    cfg = TrainerConfig(plan=plan, policy_lag=1)
    assert cfg.ring_size == 1 + 7 + 1


SPECS = ["workers=1", "workers=4:ps:ssp", "hosts=2:allreduce:bsp,"
         "workers=2:gossip:asp", "workers=4:allreduce:bsp,"
         "shard=2:allreduce:bsp:shard", "workers=2:allreduce:bsp,"
         "shard=2:allreduce:bsp:zero3", "workers=2:allreduce:bsp,"
         "replay=2:allreduce:bsp:replay", "workers=1:allreduce:asp,"
         "replay=4:allreduce:bsp:replay", "workers=2:allreduce:bsp,"
         "shard=2:allreduce:bsp:zero3,replay=2:allreduce:bsp:replay"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_and_describe_match_the_reference(spec):
    kw = dict(max_delay=3, staleness_bound=2, actors=(8, 16))
    plan = DistPlan.parse(spec, **kw)
    _same_plan(plan, JaxPlan.parse(spec, **kw))
    assert DistPlan.parse(plan.describe().split(";")[0], **kw) == plan


def test_constructors_match_parse_and_the_reference():
    pairs = [
        (DistPlan.zero(4, 2), JaxPlan.zero(4, 2),
         "workers=4:allreduce:bsp,shard=2:allreduce:bsp:shard"),
        (DistPlan.zero3(2, 2), JaxPlan.zero3(2, 2),
         "workers=2:allreduce:bsp,shard=2:allreduce:bsp:zero3"),
        (DistPlan.replay(2, 2), JaxPlan.replay(2, 2),
         "workers=2:allreduce:bsp,replay=2:allreduce:bsp:replay"),
        (DistPlan.flat(3, "gossip", "ssp", 6, 2), JaxPlan.flat(
            3, "gossip", "ssp", 6, 2), "workers=3:gossip:ssp"),
        (DistPlan.grid(2, 4, inter="gossip", intra_sync="asp"),
         JaxPlan.grid(2, 4, inter="gossip", intra_sync="asp"),
         "hosts=2:gossip:bsp,workers=4:allreduce:asp")]
    for port, ref, spec in pairs:
        assert port.describe() == spec
        _same_plan(port, ref)
        assert DistPlan.parse(spec, max_delay=port.axes[0].max_delay,
                              staleness_bound=port.axes[0].staleness_bound
                              ) == port


def test_plan_parse_shard_role_round_trip():
    s = "workers=4:allreduce:bsp,shard=2:allreduce:bsp:shard"
    plan = DistPlan.parse(s)
    assert plan.axes[1].role == "shard"
    assert plan.shard_axis is plan.axes[1]
    assert plan.shard_size == 2
    assert plan.data_axes == (plan.axes[0],)
    assert plan.describe() == s
    assert DistPlan.parse(plan.describe()) == plan


def test_plan_parse_zero3_role_round_trip():
    s = "workers=2:allreduce:bsp,shard=2:allreduce:bsp:zero3"
    plan = DistPlan.parse(s)
    assert plan.axes[1].role == "zero3"
    assert plan.shard_axis is plan.axes[1]  # zero3 IS the shard-role axis
    assert plan.shard_size == 2
    assert plan.data_axes == (plan.axes[0],)
    assert DistPlan.parse(plan.describe()) == plan


def test_plan_parse_replay_role_round_trip():
    s = "workers=2:allreduce:bsp,replay=2:allreduce:bsp:replay"
    plan = DistPlan.parse(s)
    assert plan.axes[1].role == "replay"
    assert plan.replay_axis is plan.axes[1]
    assert plan.replay_size == 2
    assert plan.shard_axis is None  # replay is NOT the shard-role slot
    # replay members replicate their data position's rollout: the
    # simulation grid collapses the axis to 1
    assert plan.sim_shape == (2, 1) and plan.sim_devices == 2
    assert plan.describe() == s
    assert DistPlan.parse(plan.describe()) == plan


def test_plan_replay_composes_with_zero3_in_grammar():
    plan = DistPlan.parse(
        "workers=2:allreduce:bsp,shard=2:allreduce:bsp:zero3,"
        "replay=2:allreduce:bsp:replay")
    assert plan.shard_axis.name == "shard"
    assert plan.replay_axis.name == "replay"
    assert plan.sim_shape == (2, 2, 1) and plan.sim_devices == 4


# every construction the reference refuses, and its message
BAD_AXES = [
    dict(name="workers", size=2, collective="star"),
    dict(name="workers", size=2, sync="eventual"),
    dict(name="", size=2), dict(name="w", size=0),
    dict(name="w", size=2, role="fsdp"),
    dict(name="shard", size=2, collective="gossip", role="shard"),
    dict(name="shard", size=2, collective="ps", role="zero3"),
    dict(name="shard", size=2, sync="asp", role="zero3"),
    dict(name="rp", size=2, collective="gossip", role="replay"),
    dict(name="rp", size=2, sync="asp", role="replay")]


@pytest.mark.parametrize("kw", BAD_AXES, ids=lambda kw: "-".join(
    f"{v}" for v in kw.values()))
def test_axis_validation_errors_are_the_references(kw):
    msg = _same_error(lambda: AxisSpec(**kw), lambda: JaxAxis(**kw))
    assert repr(kw["name"]) in msg or "name" in msg


BAD_PLANS = [
    lambda A: ((A("w", 2), A("w", 2)), None),
    lambda A: ((A("s1", 2, role="shard"), A("s2", 2, role="shard")), None),
    lambda A: ((A("s1", 2, role="shard"), A("s2", 2, role="zero3")), None),
    lambda A: ((A("r1", 2, role="replay"), A("r2", 2, role="replay")),
               None),
    lambda A: ((A("w", 1),), (4, 0)),
    lambda A: ((A("w", 1),), ()),
    lambda A: ((), None)]


@pytest.mark.parametrize("i", range(len(BAD_PLANS)))
def test_plan_validation_errors_are_the_references(i):
    def build(plan_cls, axis_cls):
        axes, actors = BAD_PLANS[i](axis_cls)
        return lambda: plan_cls(axes=axes, actors=actors)
    msg = _same_error(build(DistPlan, AxisSpec), build(JaxPlan, JaxAxis))
    assert any(w in msg for w in ("duplicate", "at most one", "actors",
                                  "empty"))


BAD_SPECS = [("", "empty plan"), ("   ", "empty plan"),
             ("workers:4", "workers:4"),
             ("workers=x", "'x' is not an integer"),
             ("workers=4:allreduce:bsp:shard:x", "too many"),
             ("w=2:allreduce:bsp:zero", "role"), ("w=2,x=1,", "''"),
             ("w=2:allreduce,w=2:gossip", "duplicate"),
             ("w=2:allreduce:bsp,s=2:gossip:bsp:zero3", "'s'"),
             ("w=2:allreduce:bsp,s=2:allreduce:ssp:zero3", "'s'"),
             ("s1=2:allreduce:bsp:zero3,s2=2:allreduce:bsp:zero3",
              "at most one shard"),
             ("w=2:allreduce:bsp,r=2:ps:bsp:replay", "'r'"),
             ("w=2:allreduce:bsp,r=2:allreduce:ssp:replay", "'r'"),
             ("r1=2:allreduce:bsp:replay,r2=2:allreduce:bsp:replay",
              "at most one replay"),
             ("ok=2:allreduce:bsp,nosize", "nosize"),
             ("ok=2:allreduce:bsp,w=three", "w=three"),
             ("ok=2:allreduce:bsp,w=2:allreduce:bsp:data:extra",
              "w=2:allreduce:bsp:data:extra")]


@pytest.mark.parametrize("spec,frag", BAD_SPECS)
def test_parse_rejections_name_the_input_as_the_reference(spec, frag):
    msg = _same_error(lambda: DistPlan.parse(spec),
                      lambda: JaxPlan.parse(spec))
    assert frag in msg, (spec, msg)


_NAMES = ("a", "b", "hosts", "workers", "shard", "x1", "grp")


def _random_plan(rng):
    """A random valid plan over every role slot (shard/zero3 and replay
    may coexist), the reference's hypothesis strategy as numpy draws."""
    n_axes = int(rng.integers(1, 5))
    names = list(rng.permutation(_NAMES))
    max_delay, staleness = (int(v) for v in rng.integers(0, 7, 2))
    shard_at = None if rng.random() < 0.4 else int(rng.integers(n_axes))
    replay_at = None if rng.random() < 0.4 else int(rng.integers(n_axes))
    if replay_at == shard_at:
        replay_at = None
    axes = []
    for i in range(n_axes):
        if i == shard_at:
            coll, role = "allreduce", str(rng.choice(("shard", "zero3")))
        elif i == replay_at:
            coll, role = "allreduce", "replay"
        else:
            coll, role = str(rng.choice(("allreduce", "ps", "gossip"))), \
                "data"
        sync_ = ("bsp" if role in ("zero3", "replay")
                 else str(rng.choice(("bsp", "asp", "ssp"))))
        axes.append((names[i], int(rng.integers(1, 9)), coll, sync_,
                     max_delay, staleness, role))
    return axes, max_delay, staleness


@pytest.mark.parametrize("seed", range(4))
def test_parse_describe_round_trip_over_random_plans(seed):
    """parse(describe(plan)) == plan, and the reference reads the same
    plan from the same string, over 50 random plans per seed."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        axes, max_delay, staleness = _random_plan(rng)
        plan = DistPlan(axes=tuple(AxisSpec(*a) for a in axes))
        s = plan.describe()
        again = DistPlan.parse(s, max_delay=max_delay,
                               staleness_bound=staleness)
        assert again == plan and again.describe() == s
        _same_plan(again, JaxPlan.parse(s, max_delay=max_delay,
                                        staleness_bound=staleness))


def test_actor_schedule_cycles_as_the_reference():
    plan, ref = DistPlan.flat(1, actors=(8, 16, 4)), JaxPlan.flat(
        1, actors=(8, 16, 4))
    for i in range(7):
        assert plan.actor_schedule(i, 32) == ref.actor_schedule(i, 32)
    assert DistPlan.flat(1).actor_schedule(5, 32) == 32


# ------------------------------------------------ (b) delay schedules
def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("seed", range(0, 50, 5))
def test_ssp_delays_bounded(seed):
    cfg = sync.SyncConfig("ssp", 8, max_delay=10, staleness_bound=2)
    d = sync.make_delays(cfg, 50, _gen(seed))
    assert d.dtype == torch.int32 and d.shape == (50, 8)
    assert int(d.max()) <= 2 and int(d.min()) >= 0
    assert int(d.max()) == 2   # the bound is reached, not just respected


def test_delay_laws():
    bsp = sync.make_delays(sync.SyncConfig("bsp", 4), 30, _gen(0))
    assert bsp.shape == (30, 4) and int(bsp.abs().max()) == 0
    asp = sync.make_delays(sync.SyncConfig("asp", 4, max_delay=5), 400,
                           _gen(1))
    assert int(asp.min()) == 0 and int(asp.max()) == 5
    assert len(torch.unique(asp)) == 6     # every value in [0, 5] drawn
    with pytest.raises(ValueError):
        sync.make_delays(sync.SyncConfig("eventual", 2), 3, _gen(0))


def test_pipeline_depth_is_the_references():
    for mech in sync.MECHANISMS:
        cfg = sync.SyncConfig(mech, 2, max_delay=5, staleness_bound=2)
        ref = jax_sync.SyncConfig(mech, 2, max_delay=5, staleness_bound=2)
        assert sync.pipeline_depth(cfg) == jax_sync.pipeline_depth(ref)
    assert sync.MECHANISMS == jax_sync.MECHANISMS


def test_plan_delay_schedule_adds_per_axis():
    plan = DistPlan(axes=(
        AxisSpec("hosts", 2, sync="asp", max_delay=3),
        AxisSpec("workers", 4, sync="bsp")))
    d = plan.make_delay_schedule(10, _gen(0))
    assert d.shape == (10, 2, 4)
    # bsp inner axis adds nothing: delays constant across workers
    assert torch.equal(d, d[:, :, :1].expand(d.shape))
    assert int(d.max()) <= 3


def test_plan_delays_of_two_stale_axes_add():
    """Two asp axes: each coordinate's delay is the sum of its axes'
    draws, so the sum reaches past either axis's max_delay."""
    plan = DistPlan(axes=(AxisSpec("hosts", 2, sync="asp", max_delay=3),
                          AxisSpec("workers", 3, sync="ssp", max_delay=4,
                                   staleness_bound=2)))
    d = plan.make_delay_schedule(200, _gen(2))
    g = _gen(2)
    hosts = sync.make_delays(sync.SyncConfig("asp", 2, 3), 200, g)
    workers = sync.make_delays(sync.SyncConfig("ssp", 3, 4, 2), 200, g)
    assert torch.equal(d, hosts[:, :, None] + workers[:, None, :])
    assert int(d.max()) == 3 + 2


def test_plan_flat_delay_schedule_matches_legacy_sync():
    """The 1-D plan draws exactly what sync.make_delays draws from the
    same generator: the legacy schedule."""
    plan = DistPlan.flat(4, sync="ssp", max_delay=6, staleness_bound=2)
    legacy = sync.make_delays(sync.SyncConfig("ssp", 4, 6, 2), 20, _gen(3))
    assert torch.equal(plan.make_delay_schedule(20, _gen(3)), legacy)


# -------------------------------------------- (c) the stacked collectives
def test_local_shard_and_all_gather_match_the_reference():
    R, chunk = 4, 6
    vec = np.random.default_rng(0).standard_normal((R * chunk, 3)).astype(
        np.float32)
    ref_chunks = jax.vmap(lambda _: jax_topology.local_shard(
        jnp.asarray(vec), "ax", R), axis_name="ax")(jnp.arange(R))
    chunks = topology.local_shard(torch.tensor(vec), R)
    np.testing.assert_array_equal(chunks.numpy(), np.asarray(ref_chunks))
    ref_full = jax.vmap(lambda c: jax_topology.all_gather_shards(c, "ax"),
                        axis_name="ax")(ref_chunks)
    full = topology.all_gather_shards(chunks)
    np.testing.assert_array_equal(full.numpy(), np.asarray(ref_full[0]))
    np.testing.assert_array_equal(full.numpy(), vec)


@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
@pytest.mark.parametrize("R", [1, 2, 4])
def test_psum_select_matches_the_reference(R, dtype):
    n = 10
    rng = np.random.default_rng(R)
    rows = rng.standard_normal((R, n, 3)) * 10
    rows = rows.astype(np.float32) if dtype == "float32" else (
        rows.astype(np.int32) if dtype == "int32" else rows > 0)
    owner = rng.integers(0, R, n)
    own = owner[None, :] == np.arange(R)[:, None]
    ref = jax.vmap(lambda r, o: jax_topology.psum_select(r, o, "ax"),
                   axis_name="ax")(jnp.asarray(rows), jnp.asarray(own))
    got = topology.psum_select(torch.tensor(rows), torch.tensor(own))
    assert got.shape == (n, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got.numpy(), rows[owner, np.arange(n)])
    assert topology.TOPOLOGIES == jax_topology.TOPOLOGIES


# -------------------------------------------- (d) the Trainer's plan mode
@pytest.mark.parametrize("mech", ["asp", "ssp"])
def test_trainer_feeds_the_plan_delays_to_the_actor(mech):
    plan = DistPlan.flat(1, sync=mech, max_delay=3, staleness_bound=1)
    cfg = TrainerConfig(algo="ppo", iters=12, superstep=5, n_envs=4,
                        unroll=4, policy_lag=1, plan=plan,
                        algo_kwargs={"hidden": (8,)})
    tr = Trainer(envs.make("cartpole"), cfg, device="cpu")
    assert tr.agent.ring_size == 1 + plan.ring_extra + 1
    seen = []
    read = tr.agent.actor_policy
    tr.agent.actor_policy = lambda s, d=0: seen.append(d) or read(s, d)
    _, hist = tr.fit()
    assert len(seen) == 12 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(isinstance(d, int) for d in seen)
    bound = 3 if mech == "asp" else 1
    assert min(seen) >= 1 and max(seen) <= 1 + bound
    assert len(set(seen)) > 1          # the schedule varies
    # the schedule is a pure function of the seed
    seen2 = []
    tr2 = Trainer(envs.make("cartpole"), cfg, device="cpu")
    read2 = tr2.agent.actor_policy
    tr2.agent.actor_policy = lambda s, d=0: seen2.append(d) or read2(s, d)
    tr2.fit(fused=False)
    assert seen2 == seen


def test_trainer_bsp_plan_is_the_planless_fit_bitwise():
    cfg = dict(algo="a3c", iters=4, superstep=2, n_envs=4, unroll=4,
               log_every=1, algo_kwargs={"hidden": (8,)})
    env = envs.make("cartpole")
    a, ha = Trainer(env, TrainerConfig(**cfg), device="cpu").fit()
    b, hb = Trainer(env, TrainerConfig(plan=DistPlan.parse(
        "hosts=1:gossip:bsp,workers=1:ps:bsp"), **cfg), device="cpu").fit()
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    assert json.dumps(ha) == json.dumps(hb)   # NaN before the first return


@pytest.mark.parametrize("plan,role", [
    (DistPlan.zero(1, 2), "shard"), (DistPlan.zero3(1, 2), "zero3"),
    (DistPlan.zero(2, 2), "shard")])
def test_trainer_refuses_what_later_slices_port(plan, role):
    """The shard and zero3 plans these cases once saw refused (ROADMAP
    queue 1, item 12) now run: the partition of dqn's online net (cartpole,
    hidden 8: 58 params, 29 a shard) and the fit's tree-form state."""
    cfg = TrainerConfig(algo="dqn", iters=2, superstep=2, n_envs=8,
                        unroll=4, plan=plan, algo_kwargs={"hidden": (8,)})
    tr = Trainer(envs.make("cartpole"), cfg, device="cpu")
    state, hist = tr.fit()
    want = {"axis": "shard", "n_shards": 2, "size": 58, "padded": 58,
            "chunk": 29, "listwise": False}
    if role == "zero3":
        want.update(sizes=[58], chunks=[29], entries=1)
    assert tr.partition == want
    assert state.opt_state["m"]["0/w"].shape == (4, 8)
    assert all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("plan,positions,shards", [
    (DistPlan.flat(2), 2, [8, 8]),
    (DistPlan.replay(2, 2), 2, [8, 8]),
    (DistPlan.flat(1, actors=(8, 16)), 1, [8, 16])])
def test_trainer_runs_what_this_slice_ports(plan, positions, shards):
    """The plans the one-position Trainer refused: two data positions,
    two positions each with a replay group of two, an elastic schedule."""
    cfg = TrainerConfig(algo="dqn", iters=4, superstep=2, n_envs=8,
                        unroll=4, plan=plan, log_every=1,
                        algo_kwargs={"hidden": (8,)})
    tr = Trainer(envs.make("cartpole"), cfg, device="cpu")
    state, hist = tr.fit()
    assert tr.n_positions == positions and tr.actor_shards == shards
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    assert state.extra["replay"]["prio"].shape == (20000,)


def test_trainer_runs_a_constant_actor_schedule_and_size_one_axes():
    plan = DistPlan.parse("hosts=1:ps:ssp,workers=1:gossip:asp,"
                          "shard=1:allreduce:bsp:zero3", actors=(4, 4))
    cfg = TrainerConfig(algo="impala", iters=3, superstep=2, n_envs=4,
                        unroll=4, plan=plan, algo_kwargs={"hidden": (8,)})
    tr = Trainer(envs.make("cartpole"), cfg, device="cpu")
    _, hist = tr.fit()
    assert tr.actor_shards == [4, 4] and np.isfinite(hist[-1]["loss"])


# ------------------------------------------------------------- (e) CLI
def _run_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rl_train.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


SMALL = ["--device", "cpu", "--iters", "3", "--superstep", "2",
         "--n-envs", "4", "--unroll", "8", "--log-every", "1"]


@pytest.mark.parametrize("R", [2, 4])
def test_cli_replay_plan_prints_partition_replay(R):
    spec = f"workers=1:allreduce:bsp,replay={R}:allreduce:bsp:replay"
    out = _run_cli(SMALL + ["--algo", "dqn", "--plan", spec])
    assert out["plan"] == spec and out["n_devices"] == R
    assert out["partition_replay"] == {"axis": "replay", "n_shards": R,
                                       "capacity": 20000,
                                       "chunk": 20000 // R}
    assert all(np.isfinite(h["loss"]) for h in out["history"])


@pytest.mark.parametrize("mech", ["asp", "ssp"])
def test_cli_sync_runs_one_worker(mech):
    out = _run_cli(SMALL + ["--algo", "ppo", "--sync", mech,
                            "--max-delay", "3", "--staleness-bound", "1"])
    assert out["plan"] == f"workers=1:allreduce:{mech}"
    assert out["n_devices"] == 1 and out["partition_replay"] is None
    assert all(np.isfinite(h["loss"]) for h in out["history"])


@pytest.mark.parametrize("flags,n_devices", [
    (["--plan", "workers=2:allreduce:bsp,replay=2:allreduce:bsp:replay"],
     4),
    (["--n-workers", "4", "--sync", "ssp"], 4),
    # refused by name until the sharded learner-state slice
    (["--plan", "workers=1:allreduce:bsp,shard=2:allreduce:bsp:shard"], 2)])
def test_cli_runs_multi_position_plans(flags, n_devices):
    out = _run_cli(SMALL + ["--algo", "dqn"] + flags)
    assert out["n_devices"] == n_devices and out["actor_shards"] == [4, 4]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    if "shard" in flags[-1]:
        assert out["partition"]["n_shards"] == 2
        assert out["partition"]["chunk"] * 2 == out["partition"]["padded"]


@pytest.mark.parametrize("flags,frags", [
    (["--plan", "workers=1:allreduce:bsp,r=2:ps:bsp:replay"],
     ["axis 'r'", "allreduce"]),
    (["--algo", "ppo", "--plan",
      "workers=1:allreduce:bsp,replay=2:allreduce:bsp:replay"],
     ["'ppo'", "PrioritizedReplay"])])
def test_cli_refuses_by_name(flags, frags, capsys):
    with pytest.raises(SystemExit) as exc:
        rl_train.main(["--device", "cpu"] + flags)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    for frag in frags:
        assert frag in err, (frag, err)
