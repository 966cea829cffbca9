"""ZeRO learner-state sharding in the port (repro_torch.core.{agent,
topology,trainer}) on the CPU, against the reference and against the
port's own flat plans:

  (a) `flatten_and_pad` and the partition hooks (the trunk's per-block
      entries, DQN's online net) against the reference's on the same
      params: the padded vectors, sizes and chunks equal, bitwise;
  (b) `reduce_scatter_mean`, one ZeRO-2 learner step and one ZeRO-3
      learner step and rollout read at 2 members (a `PositionGroup`, one
      thread each) against the reference's under
      `jax.vmap(axis_name="shard")`, at the tolerances of
      tests/test_torch_multi_position_step.py;
  (c) fits: a size-1 shard axis is a bitwise no-op, `zero(4, 2)` and
      `zero3(4, 2)` are bitwise `flat(8)` for every algorithm (params,
      the reassembled opt_state, ring, history), the layer-wise trunk
      under zero3 is bitwise `flat(4)`, zero3 + replay dqn is bitwise
      `flat(4)` with the flat buffer returned;
  (d) every position's TrainState bytes after two iterations against the
      ZeRO arithmetic (flat 16P, ZeRO-2 10P, ZeRO-3 4P at W = 4);
  (e) an unbound wrapper raises instead of gathering from itself.
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as jenvs
from repro.core import agent as jax_agents
from repro.core import topology as jax_topology
from repro.core.agent import flatten_and_pad as jax_flatten_and_pad
from repro.core.distribution import DistPlan as JaxPlan
from repro.core.rollout import rollout_fresh as jax_rollout_fresh
import repro_torch.envs as envs
from repro_torch.checkpoint.convert import (params_from_jax, ring_from_jax,
                                            train_state_from_jax)
from repro_torch.core import agent as agent_api
from repro_torch.core import topology
from repro_torch.core.agent import TrainState, flatten_and_pad
from repro_torch.core.distribution import DistPlan
from repro_torch.core.positions import PositionGroup, tree_leaves
from repro_torch.core.topology import (CHUNK, ZeRO3Agent,
                                       zero_sharded_optimizer)
from repro_torch.core.trainer import Trainer, TrainerConfig

TOL = dict(atol=1e-5, rtol=1e-5)
HIDDEN = (16, 16)
DQN_KW = dict(replay_capacity=64, batch_size=16, warmup=0, target_update=2,
              total_iters=10)
TRUNK = dict(policy="trunk", trunk_kwargs={"reduced": True})
ALGOS = ("a3c", "dqn", "impala", "ppo")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_agent(name, **kw):
    return jax_agents.make(name, env=jenvs.make("cartpole"), ring_size=2,
                           **kw)


def _port_agent(name, **kw):
    return agent_api.make(name, env=envs.make("cartpole"), ring_size=2,
                          device="cpu", **kw)


# ----------------------------------------- (a) flatten and the partitions
@pytest.mark.parametrize("name,kw", [
    ("impala", {"hidden": HIDDEN}), ("dqn", {"hidden": HIDDEN}),
    ("impala", TRUNK)])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_flatten_and_pad_matches_the_reference(name, kw, n):
    jag = _jax_agent(name, **kw)
    jstate = jag.init(jax.random.PRNGKey(0))
    jpart = jag.partition_spec(jstate)
    want, wsize, _ = jax_flatten_and_pad(jpart, n)
    tag = _port_agent(name, **kw)
    tstate = train_state_from_jax(_np(jstate))
    part = tag.partition_spec(tstate)
    vec, size, unravel = flatten_and_pad(part, n)
    assert size == int(wsize) and vec.numel() == want.size
    np.testing.assert_array_equal(vec.numpy(), np.asarray(want))
    back = unravel(vec[:size])
    assert list(back) == list(part)          # the dict's own key order
    for k, v in part.items():
        assert torch.equal(back[k], v) and back[k].data_ptr() != \
            vec.data_ptr()
    # DQN's rest is the target net and the counter, grafted back whole
    params = tag.replace_partition(tag.replace_partition(tstate.params,
                                                         None), part)
    assert list(params) == list(tstate.params)


@pytest.mark.parametrize("n", [2, 4])
def test_trunk_partition_list_matches_the_reference(n):
    jag = _jax_agent("impala", **TRUNK)
    jstate = jag.init(jax.random.PRNGKey(0))
    jentries = jag.partition_list(jag.partition_spec(jstate))
    tag = _port_agent("impala", **TRUNK)
    tstate = train_state_from_jax(_np(jstate))
    entries = tag.partition_list(tag.partition_spec(tstate))
    assert isinstance(entries, agent_api.PartitionList)
    assert len(entries) == len(jentries) == tag.policy.lm.repeats + 1
    for e, je in zip(entries, jentries):
        want, wsize, _ = jax_flatten_and_pad(je, n)
        vec, size, _ = flatten_and_pad(e, n)
        assert size == int(wsize)
        np.testing.assert_array_equal(vec.numpy(), np.asarray(want))
    merged = tag.merge_partition_list(entries)
    assert sorted(merged) == sorted(tstate.params)
    # the wrappers' geometry: the reference's, entry for entry
    jz = jax_topology.ZeRO3Agent(jag, "shard", n)
    jz.init(jax.random.PRNGKey(0))
    tz = ZeRO3Agent(tag, "shard", n)
    tz.init(torch.Generator().manual_seed(0))
    g = tz.geometry
    assert g.listwise and jz._listwise
    assert (list(g.sizes), list(g.chunks), list(g.paddeds)) == (
        jz._sizes, jz._chunks, jz._paddeds)
    # DQN's policy has no blocks: the whole-vector path
    assert _port_agent("dqn", **TRUNK).partition_list({}) is None


# ---------------------------------------- (b) learner steps against JAX
def test_reduce_scatter_mean_matches_the_reference():
    R, chunk = 4, 5
    vecs = np.random.default_rng(1).standard_normal(
        (R, R * chunk)).astype(np.float32)
    want = jax.vmap(lambda v: jax_topology.reduce_scatter_mean(v, "ax", R),
                    axis_name="ax")(jnp.asarray(vecs))
    got = topology.reduce_scatter_mean(torch.tensor(vecs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _trajectories(jag, jstate, M, T=8, B=4, seed=1):
    jenv = jenvs.make("cartpole")
    rolls = [jax_rollout_fresh(jag.policy, jag.actor_policy(jstate, 0),
                               jenv, k, T, B)
             for k in jax.random.split(jax.random.PRNGKey(seed), M)]
    traj = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                  *[r[0] for r in rolls])
    boot = jnp.stack([jax.vmap(jenv.obs)(r[1]) for r in rolls])
    return traj, boot


def _chunk_state(opt_state):
    """A reference chunk-form opt_state (moments as (chunk,) arrays) in
    the port's form (moments as {CHUNK: chunk})."""
    return {k: (torch.tensor(np.asarray(v)) if k == "step"
                else {CHUNK: torch.tensor(np.asarray(v))})
            for k, v in opt_state.items()}


def _port_state(host, r, zero3):
    """Member r's port TrainState from a reference state (numpy leaves;
    under zero3 in host layout, member r holding chunk r)."""
    from repro_torch.checkpoint.convert import _tensors
    opt = _chunk_state(host.opt_state)
    if not zero3:
        st = train_state_from_jax(jax_agents.TrainState(
            host.params, {}, host.extra, host.ring, host.steps))
        return TrainState(st.params, opt, st.extra, st.ring, st.steps)
    rest = host.params["rest"]
    return TrainState(
        {"zero3": [torch.tensor(c[r]) for c in host.params["zero3"]],
         "rest": None if rest is None else params_from_jax(
             {k: v for k, v in rest.items() if v is not None})},
        opt, _tensors(host.extra), [torch.tensor(c[r]) for c in host.ring],
        torch.tensor(host.steps))


def _learner(name, ag, state, traj, boot, key, grad_tx):
    """The port's learner step (through the wrapper under zero3) with the
    reference's randomness: PPO's permutations and DQN's Gumbel noise
    drawn from the member's key."""
    inner = ag.inner if isinstance(ag, ZeRO3Agent) else ag
    if name == "ppo":
        perms = np.stack([np.asarray(jax.random.permutation(
            k, traj["reward"].numel()))
            for k in jax.random.split(key, inner.n_epochs)])
        inner.learner_step = lambda st, tr, bo, g, **kw: \
            type(inner).learner_step_perms(inner, st, tr, bo,
                                           torch.tensor(perms), **kw)
    if name == "dqn":
        noise = jax.random.gumbel(key, (DQN_KW["replay_capacity"],))
        inner.learner_step = lambda st, tr, bo, g, **kw: \
            type(inner).learner_step_noise(
                inner, st, tr, bo, torch.tensor(np.asarray(noise)), **kw)
    return ag.learner_step(state, traj, boot, None, grad_tx=grad_tx)


def _steps(name, zero3, M=2):
    """One learner step, then the rollout's params read, of a 2-member
    shard group: the reference's under vmap(axis_name="shard") and the
    port's in a PositionGroup, from the same state and trajectories."""
    kw = dict(hidden=HIDDEN, **(DQN_KW if name == "dqn" else {}))
    jag = _jax_agent(name, **kw)
    jag.opt = jax_topology.zero_sharded_optimizer(jag.opt, "shard", M)
    if zero3:
        jag = jax_topology.ZeRO3Agent(jag, "shard", M)
    jstate = jag.init(jax.random.PRNGKey(0))   # host layout under zero3
    traj, boot = _trajectories(
        jag.inner if zero3 else jag,
        jag.host_state(jstate) if zero3 else jstate, M)
    keys = jax.random.split(jax.random.PRNGKey(2), M)
    jgrad, _ = JaxPlan.flat(M, axis="shard").compile_collectives()

    def member(state, tr, bo, k):
        new, m = jag.learner_step(state, tr, bo, k, grad_tx=jgrad)
        return new, m, jag.actor_policy(new, 0)

    axes = None
    if zero3:
        axes = jax_agents.TrainState(
            {"zero3": [0] * len(jstate.params["zero3"]), "rest": None},
            None, None, [0] * len(jstate.ring), None)
    jnew, jm, jact = jax.jit(jax.vmap(member, in_axes=(axes, 0, 0, 0),
                                      axis_name="shard"))(
        jstate, traj, boot, keys)

    tag = _port_agent(name, **kw)
    tag.opt = zero_sharded_optimizer(tag.opt, "shard", M)
    if zero3:
        tag = ZeRO3Agent(tag, tag.opt.axis)
        tag.init(torch.Generator().manual_seed(0))   # the geometry
    agents = [tag] + [copy.deepcopy(tag) for _ in range(M - 1)]
    host = _np(jstate)
    grad_fn, _ = DistPlan.flat(M, axis="shard").compile_collectives()
    group = PositionGroup(M, timeout=60.0)
    for r, a in enumerate(agents):
        a.opt.axis.bind(r, group.shard_gather(r, [list(range(M))] * M))

    def work(r):
        tr = {k: torch.tensor(np.asarray(v[r])) for k, v in traj.items()}
        new, m = _learner(name, agents[r], _port_state(host, r, zero3), tr,
                          torch.tensor(np.asarray(boot[r])), keys[r],
                          group.hook(r, grad_fn, (M,)))
        return new, m, agents[r].actor_policy(new, 0)

    try:
        port = group.run(work)
    finally:
        group.close()
    return jnew, np.asarray(jm["loss"]), jact, port


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", ALGOS)
@pytest.mark.parametrize("zero3", [False, True], ids=["zero2", "zero3"])
def test_sharded_learner_step_matches_jax(name, zero3):
    jnew, jloss, jact, port = _steps(name, zero3)
    row = lambda t, r: jax.tree_util.tree_map(lambda a: np.asarray(a[r]), t)
    for r, (tnew, tm, tact) in enumerate(port):
        jr = row(jnew, r)
        assert float(tm["loss"]) == pytest.approx(float(jloss[r]), abs=1e-5,
                                                  rel=1e-5)
        for moment in ("m", "v"):   # the member's own chunk
            np.testing.assert_allclose(
                tnew.opt_state[moment][CHUNK].numpy(), jr.opt_state[moment],
                **TOL, err_msg=f"rank {r} {moment}")
        assert int(tnew.opt_state["step"]) == int(jr.opt_state["step"])
        # the rollout's params: gathered per use under zero3
        want = params_from_jax(row(jact, r))
        _close(tact, want, f"rank {r} actor")
        if zero3:
            for got, w in zip(tnew.params["zero3"], jr.params["zero3"]):
                np.testing.assert_allclose(got.numpy(), w, **TOL)
            for got, w in zip(tnew.ring, jr.ring):
                np.testing.assert_allclose(got.numpy(), w, **TOL)
        else:
            _close(tnew.params, params_from_jax(jr.params), f"rank {r}")
            _close(tnew.ring, ring_from_jax(jr.ring), f"rank {r} ring")
    # the members' gathered params are one set of numbers
    for _, _, tact in port[1:]:
        for k, v in port[0][2].items():
            assert torch.equal(tact[k], v)


# ------------------------------------------------------------- (c) fits
def _eq(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def _fit(algo, plan, iters=4, superstep=2, **kw):
    akw = {"hidden": (8,)}
    if algo == "dqn":
        akw.update(replay_capacity=512, warmup=1)
    akw.update(kw)
    cfg = TrainerConfig(algo=algo, iters=iters, superstep=superstep,
                        n_envs=8, unroll=6, plan=plan, log_every=1,
                        algo_kwargs=akw)
    tr = Trainer(envs.make("cartpole"), cfg, device="cpu")
    state, hist = tr.fit()
    return tr, state, hist


def _assert_bitwise(a, ha, b, hb, parts=("params", "opt_state", "extra",
                                         "ring", "steps")):
    for part in parts:
        assert _eq(getattr(a, part), getattr(b, part)), part
        if isinstance(getattr(a, part), dict):
            assert list(getattr(a, part)) == list(getattr(b, part)), part
    assert json.dumps(ha) == json.dumps(hb)   # NaN before the first return


@pytest.mark.parametrize("role", ["shard", "zero3"])
@pytest.mark.parametrize("algo", ALGOS)
def test_size_one_shard_axis_is_a_bitwise_noop(algo, role):
    _, a, ha = _fit(algo, DistPlan.flat(2))
    tr, b, hb = _fit(algo, DistPlan.parse(
        f"workers=2:allreduce:bsp,shard=1:allreduce:bsp:{role}"))
    assert tr.partition is None and not isinstance(tr.agent, ZeRO3Agent)
    _assert_bitwise(a, ha, b, hb)


@pytest.fixture(scope="module")
def flat8():
    return {algo: _fit(algo, DistPlan.flat(8)) for algo in ALGOS}


@pytest.mark.parametrize("make", [DistPlan.zero, DistPlan.zero3],
                         ids=["zero2", "zero3"])
@pytest.mark.parametrize("algo", ALGOS)
def test_sharded_fit_is_bitwise_flat8(flat8, algo, make):
    _, a, ha = flat8[algo]
    tr, b, hb = _fit(algo, make(4, 2))
    _assert_bitwise(a, ha, b, hb)
    size = sum(v.numel() for v in tr.agent.partition_spec(b).values())
    p = tr.partition
    assert (p["axis"], p["n_shards"], p["size"]) == ("shard", 2, size)
    assert p["padded"] == size + size % 2 and p["chunk"] == p["padded"] // 2
    assert p["listwise"] is False
    if make is DistPlan.zero3:
        assert (p["sizes"], p["chunks"], p["entries"]) == (
            [size], [p["chunk"]], 1)


@pytest.mark.parametrize("role", ["shard", "zero3"])
def test_layerwise_trunk_is_bitwise_flat(role):
    _, a, ha = _fit("impala", DistPlan.flat(4), iters=2, **TRUNK)
    tr, b, hb = _fit("impala", DistPlan.parse(
        f"workers=2:allreduce:bsp,shard=2:allreduce:bsp:{role}"), iters=2,
        **TRUNK)
    _assert_bitwise(a, ha, b, hb)
    p = tr.partition
    assert p["listwise"] is (role == "zero3")
    if role == "zero3":
        assert p["entries"] == tr.agent.policy.lm.repeats + 1
        assert sum(p["sizes"]) == p["size"] and sum(p["chunks"]) == \
            p["chunk"]


def test_zero3_with_replay_is_bitwise_flat4():
    _, a, ha = _fit("dqn", DistPlan.flat(4), iters=6, superstep=3)
    tr, b, hb = _fit("dqn", DistPlan.parse(
        "workers=2:allreduce:bsp,shard=2:allreduce:bsp:zero3,"
        "replay=2:allreduce:bsp:replay"), iters=6, superstep=3)
    _assert_bitwise(a, ha, b, hb)
    assert tr.n_positions == 4 and tr.partition_replay["n_shards"] == 2
    assert b.extra["replay"]["prio"].shape == (512,)


# --------------------------------------------------------- (d) memory
def test_state_bytes_follow_the_zero_arithmetic():
    """W = 4 positions after two iterations, adamw (m, v) and a bsp ring
    of one slot: flat 4 x (P + P + 2P), ZeRO-2 4 x (P + P) + 2 padded,
    ZeRO-3 4 padded, in f32, plus each position's two int32 counters."""
    got = {}
    for label, plan in (("flat", DistPlan.flat(4)),
                        ("zero2", DistPlan.zero(1, 4)),
                        ("zero3", DistPlan.zero3(1, 4))):
        tr, _, _ = _fit("impala", plan, iters=2)
        got[label] = tr.state_bytes
    P = 67                     # cartpole, hidden (8,)
    padded = P + (-P) % 4
    counters = 4 * 2 * 4
    assert got == {"flat": 4 * 4 * P * 4 + counters,
                   "zero2": (4 * 2 * P + 2 * padded) * 4 + counters,
                   "zero3": 4 * padded * 4 + counters}


# ------------------------------------------------- (e) unbound wrappers
def test_unbound_wrapper_raises_instead_of_gathering():
    tag = _port_agent("impala", hidden=HIDDEN)
    tag.opt = zero_sharded_optimizer(tag.opt, "shard", 2)
    z = ZeRO3Agent(tag, tag.opt.axis)
    host = z.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="bound to none"):
        z.actor_policy(host, 0)
    traj = {"reward": torch.zeros((2, 2))}
    with pytest.raises(RuntimeError, match="bound to none"):
        z.learner_step(host, traj, torch.zeros((2, 4)), None)
    # host_state reassembles, and the inner form passes to the inner
    # agent unchanged
    inner = z.host_state(host)
    assert set(inner.params) == set(z.actor_policy(inner, 0))
    assert z.host_state(inner) is inner
