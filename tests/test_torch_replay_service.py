"""The port's sharded replay service (repro_torch.core.replay_service, the
per-shard draw `shard_gumbel_topk` and its kernel binding) on the CPU
against the JAX package:

  (a) the per-shard plain draw against JAX's `shard_gumbel_topk_ref` and
      its Pallas kernel (interpret mode, as tests/test_kernels.py runs
      it) on the same priorities and Gumbel vector: indices exact; scores
      within 1e-6 absolute, because XLA's and PyTorch's CPU `log` differ
      in the last bit on some inputs (so do the scores of the two
      libraries' flat draws); and bitwise the port's own flat scores,
      shard by shard. Empty shards, k > nvalid and forced ties;
  (b) the service against JAX's `ShardedPrioritizedReplay` run under its
      vmap named axis (tests/test_replay_service.py's stand-in for the
      mesh), with JAX's Gumbel vector passed to the port's `sample_with`:
      `add_batch`, `sample_with`, `update_priorities`, `shard_state` and
      `unshard_state` for R in {1, 2, 4}, fills 0, partial and full, and
      n > chunk. Indices exact, stores and rows bitwise, priorities
      bitwise (max, abs and + eps round alike), weights within
      rtol = atol = 1e-5 of JAX's (its log/exp) and bitwise the port's
      flat fused draw;
  (c) a DQN learner_step through the service against JAX's under vmap,
      three steps (warmup, after it, across a target sync), the tolerances
      of tests/test_torch_dqn.py;
  (d) the Trainer: a `DistPlan.replay(1, R)` DQN fit bitwise the port's
      flat fit (params, optimizer state, the reassembled buffer,
      history). JAX's own one-worker replay plan is not bitwise its
      flat(1) fit: only its mesh program folds the device index into the
      key (src/repro/core/trainer.py:295-303), a split the port's streams
      do not have, so this rule is stated on the port's fits;
  (e) twins of tests/test_replay_service.py's divisibility error and the
      Trainer's four replay-axis refusals, messages verbatim.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as jenvs
import repro_torch.envs as envs
from repro.core import agent as jax_agents
from repro.core.distribution import DistPlan as JaxPlan
from repro.core.replay import PrioritizedReplay as JaxPrioritized
from repro.core.replay_service import ShardedPrioritizedReplay as JaxService
from repro.core.rollout import rollout_fresh as jax_rollout_fresh
from repro.kernels.replay_sample.ops import shard_topk as jax_shard_kernel
from repro.kernels.replay_sample.ref import \
    shard_gumbel_topk_ref as jax_shard_ref
from repro_torch.checkpoint.convert import (params_from_jax,
                                            train_state_from_jax)
from repro_torch.core import agent as agent_api
from repro_torch.core.distribution import DistPlan
from repro_torch.core.replay import PrioritizedReplay
from repro_torch.core.replay_sample import shard_gumbel_topk
from repro_torch.core.replay_service import ShardedPrioritizedReplay
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.kernels.replay_sample import ops
from repro_torch.kernels.replay_sample.kernel import shard_topk_c
from repro_torch.kernels.replay_sample.ref import (
    prioritized_sample_ref, shard_gumbel_topk_ref,
    shard_gumbel_topk_stack_ref)

TOL = dict(atol=1e-5, rtol=1e-5)
SCORE_ATOL = 1e-6   # one f32 ulp of a score below 8 is at most 4.8e-7


def _prio_gumbel(C, ties, seed):
    """Priorities from a numpy seed and JAX's Gumbel vector, float32."""
    prio = (np.abs(np.random.default_rng(seed).standard_normal(C))
            + 0.01).astype(np.float32)
    gumbel = np.array(jax.random.gumbel(jax.random.PRNGKey(seed), (C,)))
    if ties:
        prio[1::7] = prio[0]
        gumbel[1::7] = gumbel[0]
    return prio, gumbel


# -------------------------------------------- (a) the per-shard draw
# (chunk, nvalid, k): full, partial, empty, k > nvalid, k = chunk, k = 1
SHARD_CASES = [(64, 64, 16), (64, 40, 16), (64, 0, 16), (64, 5, 32),
               (100, 100, 100), (131, 77, 1), (48, 12, 48)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("chunk,nvalid,k", SHARD_CASES)
def test_shard_ref_matches_jax_ref_and_kernel(chunk, nvalid, k, ties):
    prio, gumbel = _prio_gumbel(chunk, ties, seed=chunk + nvalid + k)
    s, idx = shard_gumbel_topk_ref(torch.tensor(prio),
                                   torch.tensor(nvalid, dtype=torch.int32),
                                   torch.tensor(gumbel), k)
    assert s.dtype == torch.float32 and idx.dtype == torch.int32
    assert s.shape == idx.shape == (k,)
    for js, ji in (jax_shard_ref(jnp.asarray(prio), nvalid,
                                 jnp.asarray(gumbel), k),
                   jax_shard_kernel(jnp.asarray(prio), jnp.int32(nvalid),
                                    jnp.asarray(gumbel), k)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        js = np.asarray(js)
        np.testing.assert_array_equal(np.isneginf(s.numpy()),
                                      np.isneginf(js))
        np.testing.assert_allclose(s.numpy(), js, atol=SCORE_ATOL, rtol=0)
    # past the filled count: -inf at idx = position
    tail = np.arange(min(nvalid, k), k)
    np.testing.assert_array_equal(idx.numpy()[tail], tail)
    assert np.isneginf(s.numpy()[tail]).all()


@pytest.mark.parametrize("R,size", [(1, 30), (2, 90), (4, 128), (4, 33)])
def test_shard_scores_are_the_flat_scores_bitwise(R, size):
    """The shards' candidates carry the flat draw's scores bitwise: each
    shard's filled candidates are its slice's top scores, the same
    numbers the flat score vector holds at those slots."""
    C = 128
    chunk = C // R
    prio, gumbel = _prio_gumbel(C, ties=True, seed=R)
    p, g = torch.tensor(prio), torch.tensor(gumbel)
    valid = torch.arange(C) < size
    flat = torch.where(valid, 0.6 * torch.log(p + 1e-6) + g, -torch.inf)
    nv = torch.clamp(size - torch.arange(R) * chunk, 0, chunk).int()
    s, idx = shard_gumbel_topk_stack_ref(p.view(R, chunk), nv,
                                         g.view(R, chunk), chunk)
    for r in range(R):
        assert torch.equal(s[r], flat[r * chunk + idx[r].long()])


def test_stack_is_the_ref_row_by_row():
    R, chunk, k = 3, 50, 20
    prio, gumbel = _prio_gumbel(R * chunk, ties=True, seed=9)
    p = torch.tensor(prio).view(R, chunk)
    g = torch.tensor(gumbel).view(R, chunk)
    nv = torch.tensor([50, 7, 0], dtype=torch.int32)
    s, idx = shard_gumbel_topk_stack_ref(p, nv, g, k)
    for r in range(R):
        sr, ir = shard_gumbel_topk_ref(p[r], nv[r], g[r], k)
        assert torch.equal(s[r], sr) and torch.equal(idx[r], ir)


def test_seam_and_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the seam (either flag), the ops layer and the kernel
    binding all give the plain draw; none counts a kernel launch."""
    prio, gumbel = _prio_gumbel(120, ties=True, seed=5)
    p = torch.tensor(prio).view(4, 30)
    g = torch.tensor(gumbel).view(4, 30)
    nv = torch.tensor([30, 30, 11, 0], dtype=torch.int32)
    want = shard_gumbel_topk_stack_ref(p, nv, g, 12, alpha=0.7, eps=1e-5)
    before = shard_topk_c.launches
    for got in (shard_gumbel_topk(p, nv, g, 12, 0.7, 1e-5, use_kernel=True),
                shard_gumbel_topk(p, nv, g, 12, 0.7, 1e-5),
                ops.shard_topk(p, nv, g, 12, 0.7, 1e-5),
                shard_topk_c(p, g, nv, 12, 0.7, 1e-5)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert shard_topk_c.launches == before


# ------------------------------------------- (b) the service against JAX
def _example():
    return {"obs": np.zeros(3, np.float32), "action": np.zeros((), np.int32),
            "reward": np.zeros((), np.float32), "done": np.zeros((), bool)}


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, 3)).astype(np.float32),
            "action": rng.integers(0, 4, n).astype(np.int32),
            "reward": rng.standard_normal(n).astype(np.float32),
            "done": rng.random(n) < 0.3}


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _vm(svc, fn, n_rest):
    """A JAX service method under the vmap stand-in for the mesh axis (as
    tests/test_replay_service.py runs it)."""
    return jax.vmap(fn, in_axes=(0,) + (None,) * n_rest, axis_name=svc.axis)


def _fill_both(C, R, sizes, priorities):
    """The same add_batch sequence into the port's service (stacked) and
    JAX's (under vmap), each from its own empty flat buffer."""
    port = ShardedPrioritizedReplay(C, "replay", R)
    ref = JaxService(C, "replay", R)
    ps = port.shard_state(PrioritizedReplay(C, fused=True).init(
        _t(_example())))
    rs = ref.shard_state(JaxPrioritized(C, fused=True).init(
        _j(_example())))
    add = _vm(ref, ref.add_batch, 2)
    add_default = _vm(ref, lambda s, b: ref.add_batch(s, b), 1)
    for i, n in enumerate(sizes):
        b = _batch(n, seed=10 * R + i)
        if priorities:
            pr = (np.random.default_rng(100 + i).random(n).astype(np.float32)
                  + 0.5)
            ps = port.add_batch(ps, _t(b), torch.tensor(pr))
            rs = add(rs, _j(b), jnp.asarray(pr))
        else:
            ps = port.add_batch(ps, _t(b))
            rs = add_default(rs, _j(b))
    return port, ref, ps, rs


def _assert_same_buffer(port, ref, ps, rs):
    """The port's stacked state equals JAX's member states bitwise, and
    the two unsharded buffers are equal."""
    for k, v in rs["store"].items():
        np.testing.assert_array_equal(ps["store"][k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(ps["prio"].numpy(), np.asarray(rs["prio"]))
    for k in ("ptr", "size"):   # JAX tiles the shared scalars over (R,)
        assert (np.asarray(rs[k]) == int(ps[k])).all(), k
    pf, rf = port.unshard_state(ps), ref.unshard_state(rs)
    for k, v in rf["store"].items():
        np.testing.assert_array_equal(pf["store"][k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(pf["prio"].numpy(), np.asarray(rf["prio"]))
    assert int(pf["ptr"]) == int(rf["ptr"])
    assert int(pf["size"]) == int(rf["size"])


# fills: empty, partial, exactly full, wrapped past capacity
FILLS = {"empty": (), "partial": (5, 16), "full": (40, 24),
         "wrapped": (30, 30, 17)}


@pytest.mark.parametrize("priorities", [False, True])
@pytest.mark.parametrize("fill", list(FILLS))
@pytest.mark.parametrize("R", [1, 2, 4])
def test_add_batch_matches_jax(R, fill, priorities):
    port, ref, ps, rs = _fill_both(64, R, FILLS[fill], priorities)
    _assert_same_buffer(port, ref, ps, rs)


@pytest.mark.parametrize("n", [16, 40])          # 40 > chunk at R = 2, 4
@pytest.mark.parametrize("fill", list(FILLS))
@pytest.mark.parametrize("R", [1, 2, 4])
def test_sample_with_matches_jax(R, fill, n):
    C = 64
    port, ref, ps, rs = _fill_both(C, R, FILLS[fill], priorities=True)
    key = jax.random.PRNGKey(7 * R + n)
    jb, ji, jw = _vm(ref, ref.sample, 2)(rs, key, n)
    g = torch.tensor(np.asarray(jax.random.gumbel(key, (C,))))
    pb, pi, pw = port.sample_with(ps, g.view(R, C // R), n)
    assert pi.dtype == torch.int32 and pi.shape == (n,)
    for r in range(R):   # every JAX member returns the global result
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji[r]))
        for k, v in jb.items():
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(v[r]))
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw[r]), **TOL)
    # bitwise the port's flat fused draw on the same buffer and noise
    flat = PrioritizedReplay(C, fused=True)
    fb, fi, fw = flat.sample_with(port.unshard_state(ps), g, n)
    assert torch.equal(fi, pi) and torch.equal(fw, pw)
    for k in fb:
        assert torch.equal(fb[k], pb[k])
    assert int(pi.max()) < max(int(ps["size"]), 1)


@pytest.mark.parametrize("R", [1, 2, 4])
def test_update_priorities_matches_jax(R):
    C, n = 64, 24
    port, ref, ps, rs = _fill_both(C, R, (48,), priorities=False)
    key = jax.random.PRNGKey(3)
    _, ji, _ = _vm(ref, ref.sample, 2)(rs, key, n)
    g = torch.tensor(np.asarray(jax.random.gumbel(key, (C,)))).view(R, -1)
    _, pi, _ = port.sample_with(ps, g, n)
    td = np.random.default_rng(4).standard_normal(n).astype(np.float32) * 3
    rs = _vm(ref, ref.update_priorities, 2)(rs, ji[0], jnp.asarray(td))
    ps = port.update_priorities(ps, pi, torch.tensor(td))
    _assert_same_buffer(port, ref, ps, rs)
    # the write-back moved mass: the drawn slots carry |td| + eps
    flat = port.unshard_state(ps)["prio"].numpy()
    np.testing.assert_array_equal(flat[pi.numpy()],
                                  np.abs(td) + np.float32(port.eps))


@pytest.mark.parametrize("R", [1, 2, 4])
def test_shard_unshard_match_jax_and_round_trip(R):
    C = 48
    flat_p = PrioritizedReplay(C, fused=True)
    flat_j = JaxPrioritized(C, fused=True)
    b = _batch(30, seed=1)
    fs = flat_p.add_batch(flat_p.init(_t(_example())), _t(b))
    fj = flat_j.add_batch(flat_j.init(_j(_example())), _j(b))
    port, ref = ShardedPrioritizedReplay(C, "rp", R), JaxService(C, "rp", R)
    ps, rs = port.shard_state(fs), ref.shard_state(fj)
    assert ps["prio"].shape == (R, C // R)
    assert ps["store"]["obs"].shape == (R, C // R, 3)
    assert ps["ptr"].shape == ps["size"].shape == ()   # shared scalars
    _assert_same_buffer(port, ref, ps, rs)
    back = port.unshard_state(ps)
    for k in fs["store"]:
        assert torch.equal(back["store"][k], fs["store"][k])
    assert torch.equal(back["prio"], fs["prio"])
    assert int(back["ptr"]) == int(fs["ptr"])
    assert int(back["size"]) == int(fs["size"])


def test_init_is_the_sharded_empty_buffer():
    port = ShardedPrioritizedReplay(64, "replay", 4)
    a = port.init(_t(_example()))
    b = port.shard_state(PrioritizedReplay(64, fused=True).init(
        _t(_example())))
    for k in b["store"]:
        assert torch.equal(a["store"][k], b["store"][k])
    assert torch.equal(a["prio"], b["prio"])
    assert int(a["ptr"]) == int(a["size"]) == 0


def test_noise_is_the_flat_draw():
    """The service's noise is the flat fused buffer's (capacity,) Gumbel
    vector from the same generator state, seen as (R, chunk)."""
    port = ShardedPrioritizedReplay(64, "replay", 4)
    flat = PrioritizedReplay(64, fused=True)
    a = port.noise(torch.Generator().manual_seed(3), 16)
    b = flat.noise(torch.Generator().manual_seed(3), 16)
    assert a.shape == (4, 16) and torch.equal(a.reshape(-1), b)


def test_empty_buffer_draws_slot_zero():
    """size = 0: the global max(size, 1) guard makes slot 0 of shard 0
    the one filled slot; every position draws it, with finite weights."""
    port = ShardedPrioritizedReplay(64, "replay", 4)
    st = port.init(_t(_example()))
    g = torch.tensor(np.asarray(jax.random.gumbel(jax.random.PRNGKey(0),
                                                  (64,)))).view(4, 16)
    _, idx, w = port.sample_with(st, g, 8)
    assert (idx == 0).all() and torch.isfinite(w).all()
    want = prioritized_sample_ref(torch.zeros(64), torch.tensor(0),
                                  g.reshape(-1), 8)
    assert torch.equal(idx, want[0]) and torch.equal(w, want[1])


# --------------------------------- (c) a DQN learner_step under the service
KW = dict(replay_capacity=64, batch_size=16, warmup=1, target_update=2,
          hidden=(16, 16))
T, B = 8, 6      # 48 transitions per step: the 64-slot ring wraps at step 2


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _close(got, want, what):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want))
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("R", [2, 4])
def test_dqn_learner_step_through_the_service_matches_jax(R, deterministic):
    jenv = jenvs.make("cartpole")
    jag = jax_agents.make("dqn", env=jenv, ring_size=2, total_iters=10, **KW)
    tag = agent_api.make("dqn", env=envs.make("cartpole"), ring_size=2,
                         total_iters=10, device="cpu", **KW)
    jsvc = JaxService(KW["replay_capacity"], "replay", R)
    tsvc = ShardedPrioritizedReplay(KW["replay_capacity"], "replay", R)
    jag.replay, tag.replay = jsvc, tsvc
    k_init, k_run = jax.random.split(jax.random.PRNGKey(0))
    js = jag.init(k_init)
    ts = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js))
    jr = jsvc.shard_state(js.extra["replay"])
    ts = agent_api.TrainState(ts.params, ts.opt_state,
                              {"replay": tsvc.shard_state(
                                  ts.extra["replay"])}, ts.ring, ts.steps)
    TS = jax_agents.TrainState

    def member(rstate, params, opt_state, ring, steps, traj, boot, key):
        new, m = jag.learner_step(TS(params, opt_state, {"replay": rstate},
                                     ring, steps), traj, boot, key)
        return new.params, new.opt_state, new.extra["replay"], new.ring, \
            new.steps, m["loss"]

    step_all = jax.vmap(member, in_axes=(0,) + (None,) * 7,
                        axis_name="replay")
    first = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)
    params, opt_state, ring, steps = (js.params, js.opt_state, js.ring,
                                      js.steps)
    for step in range(3):
        k_roll, k_learn = jax.random.split(jax.random.fold_in(k_run, step))
        jtraj, env_state = jax_rollout_fresh(
            jag.policy, jag.actor_policy(TS(params, None, None, ring, steps),
                                         0), jenv, k_roll, T, B)
        jboot = jax.vmap(jenv.obs)(env_state)
        g = torch.tensor(np.asarray(jax.random.gumbel(
            k_learn, (KW["replay_capacity"],)))).view(R, -1)
        out = step_all(jr, params, opt_state, ring, steps, jtraj, jboot,
                       k_learn)
        params, opt_state, jr, ring, steps = (first(out[0]), first(out[1]),
                                              out[2], first(out[3]),
                                              out[4][0])
        jloss = out[5][0]
        ts, tm = tag.learner_step_noise(
            ts, {k: torch.tensor(np.asarray(v)) for k, v in jtraj.items()},
            torch.tensor(np.asarray(jboot)), g)
        assert float(tm["loss"]) == pytest.approx(float(jloss), abs=1e-5,
                                                  rel=1e-5)
        assert (float(tm["loss"]) == 0.0) == (step == 0)  # warmup
        _close(ts.params, params, f"step {step} params")
        for moment in ("m", "v"):
            _close(ts.opt_state[moment], opt_state[moment], moment)
        _close(ts.ring, ring, "ring")
        tr = ts.extra["replay"]
        assert tr["prio"].shape == (R, KW["replay_capacity"] // R)
        np.testing.assert_allclose(tr["prio"].numpy(), np.asarray(jr["prio"]),
                                   **TOL)
        for k, v in jr["store"].items():
            np.testing.assert_array_equal(tr["store"][k].numpy(),
                                          np.asarray(v))
        assert int(tr["size"]) == int(jr["size"][0])
        assert int(ts.steps) == int(steps) == step + 1


# ----------------------------------------------- (d) the Trainer's fits
def _hist_equal(h1, h2):
    return len(h1) == len(h2) and all(
        r1.keys() == r2.keys() and all(
            r1[k] == r2[k] or (np.isnan(r1[k]) and np.isnan(r2[k]))
            for k in r1) for r1, r2 in zip(h1, h2))


def _fit(plan, **kw):
    cfg = TrainerConfig(algo="dqn", iters=10, superstep=4, n_envs=8,
                        unroll=8, log_every=1, plan=plan,
                        algo_kwargs=dict({"hidden": (16,),
                                          "replay_capacity": 512,
                                          "warmup": 2}, **kw))
    tr = Trainer(envs.make("cartpole"), cfg, device="cpu")
    return tr, tr.fit()


@pytest.mark.parametrize("R", [1, 2, 4])
def test_replay_plan_fit_is_the_flat_fit_bitwise(R):
    _, (sf, hf) = _fit(None)
    tr, (s, h) = _fit(DistPlan.replay(1, R))
    if R == 1:   # a size-1 replay axis stays unwrapped
        assert tr.partition_replay is None
        assert isinstance(tr.agent.replay, PrioritizedReplay)
    else:
        assert tr.partition_replay == {"axis": "replay", "n_shards": R,
                                       "capacity": 512, "chunk": 512 // R}
        assert isinstance(tr.agent.replay, ShardedPrioritizedReplay)
    for k in sf.params:
        assert torch.equal(s.params[k], sf.params[k]), k
    for moment in ("m", "v"):
        for k in sf.opt_state[moment]:
            assert torch.equal(s.opt_state[moment][k],
                               sf.opt_state[moment][k])
    rf, rp = sf.extra["replay"], s.extra["replay"]
    assert rp["prio"].shape == (512,)      # the flat buffer again
    assert torch.equal(rp["prio"], rf["prio"])
    for k in rf["store"]:
        assert torch.equal(rp["store"][k], rf["store"][k])
    assert int(rp["ptr"]) == int(rf["ptr"])
    assert int(rp["size"]) == int(rf["size"])
    assert _hist_equal(h, hf)


def test_replay_plan_fused_equals_unfused_bitwise():
    cfg = TrainerConfig(algo="dqn", iters=6, superstep=3, n_envs=8,
                        unroll=8, log_every=1, plan=DistPlan.replay(1, 2),
                        algo_kwargs={"hidden": (16,), "replay_capacity": 256,
                                     "warmup": 1})
    env = envs.make("cartpole")
    s_f, h_f = Trainer(env, cfg, device="cpu").fit(fused=True)
    s_u, h_u = Trainer(env, cfg, device="cpu").fit(fused=False)
    for k in s_f.params:
        assert torch.equal(s_f.params[k], s_u.params[k])
    assert _hist_equal(h_f, h_u)


def test_service_use_kernel_follows_the_flat_replay():
    for use_kernel in (True, False):
        cfg = TrainerConfig(algo="dqn", iters=1, n_envs=8, unroll=4,
                            plan=DistPlan.replay(1, 2),
                            algo_kwargs={"use_kernel": use_kernel})
        tr = Trainer(envs.make("cartpole"), cfg, device="cpu")
        assert tr.agent.replay.use_kernel is use_kernel


# ------------------------------------- (e) twins of the reference's tests
def test_service_capacity_divisibility_error():
    with pytest.raises(ValueError, match="not divisible") as e:
        ShardedPrioritizedReplay(100, "rp", 3)
    assert "'rp'" in str(e.value) and "100" in str(e.value)
    with pytest.raises(ValueError) as j:
        JaxService(100, "rp", 3)
    assert str(e.value) == str(j.value)


def _jax_message(algo, **kw):
    """The reference Trainer's refusal for the same config."""
    from repro.core.trainer import Trainer as JaxTrainer
    from repro.core.trainer import TrainerConfig as JaxConfig
    algo_kwargs = kw.pop("algo_kwargs", {})
    with pytest.raises(ValueError) as e:
        JaxTrainer(jenvs.CartPole(), JaxConfig(
            algo=algo, n_envs=8, plan=JaxPlan.replay(1, kw.pop("R", 2)),
            algo_kwargs=algo_kwargs, **kw))
    return str(e.value)


def test_trainer_replay_axis_rejects_unfused_dqn():
    with pytest.raises(ValueError, match="fused") as e:
        Trainer(envs.make("cartpole"), TrainerConfig(
            algo="dqn", n_envs=8, plan=DistPlan.replay(1, 2),
            algo_kwargs={"fused_sampling": False}), device="cpu")
    assert "'replay'" in str(e.value)
    assert str(e.value) == _jax_message(
        "dqn", algo_kwargs={"fused_sampling": False})


def test_trainer_replay_axis_rejects_replayless_algo():
    with pytest.raises(ValueError, match="replay") as e:
        Trainer(envs.make("cartpole"), TrainerConfig(
            algo="ppo", n_envs=8, plan=DistPlan.replay(1, 2)), device="cpu")
    assert "'ppo'" in str(e.value)
    assert str(e.value) == _jax_message("ppo")


def test_trainer_replay_axis_rejects_indivisible_capacity():
    with pytest.raises(ValueError, match="not divisible") as e:
        Trainer(envs.make("cartpole"), TrainerConfig(
            algo="dqn", n_envs=8, plan=DistPlan.replay(1, 3),
            algo_kwargs={"replay_capacity": 1000}), device="cpu")
    assert str(e.value) == _jax_message(
        "dqn", R=3, algo_kwargs={"replay_capacity": 1000})


def test_trainer_replay_axis_rejects_pipeline():
    with pytest.raises(ValueError, match="pipeline") as e:
        Trainer(envs.make("cartpole"), TrainerConfig(
            algo="dqn", n_envs=8, plan=DistPlan.replay(1, 2),
            pipeline=True), device="cpu")
    assert "'replay'" in str(e.value)
    assert "pipeline=False" in str(e.value)
    assert str(e.value) == _jax_message("dqn", pipeline=True)
