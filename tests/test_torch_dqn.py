"""The port's DQN (repro_torch.core.algos.dqn) on the CPU against
repro.core.algos.dqn, and DQN through the Trainer, the CLIs and serving:

  (a) learner_step parity: from one `train_state_from_jax` state, the same
      JAX trajectories and the same replay noise (the Gumbel vector of the
      key JAX's `replay.sample` receives), three successive steps: one
      inside warmup, one after it, one across a target sync. Params, the
      adamw state, replay priorities, ring and loss within
      rtol = atol = 1e-5 (f32 sums in another order); replay ptr/size and
      counters exact. Fused, legacy, uniform and single-Q; the trunk
      q-net runs a learner step;
      The algorithm class's own `DQN.learner_step` on a filled replay,
      twice, with the noise of the reference's key;
  (b) the ε anneal, `_QPolicy.sample_value` with explicit noise, and
      `DQN.act` with the reference's two draws of its key;
  (c) fused and unfused fits bitwise equal (the GridWorld learning bar is
      checked on the card, in chip_smoke.py, over 16 seeds);
  (d) the CLI and serving: `rl_train --algo dqn`, a served DQN batch, a
      JAX DQN Trainer archive served with its ring slot and ε.
"""
import contextlib
import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

import repro.envs as jenvs
import repro_torch.envs as envs
from repro.checkpoint.ckpt import save_checkpoint as jax_save
from repro.core import agent as jax_agents
from repro.core.rollout import rollout_fresh as jax_rollout_fresh
from repro_torch.checkpoint import load_train_state
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.checkpoint.convert import (params_from_jax, ring_from_jax,
                                            train_state_from_jax)
from repro_torch.core.algos.dqn import sub
from repro_torch.core import agent as agent_api
from repro_torch.core.rollout import rollout_fresh
from repro_torch.core.serving import ParamStore, ServeEngine
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.launch import rl_train, serve_policy

TOL = dict(atol=1e-5, rtol=1e-5)
BASE = dict(replay_capacity=64, batch_size=16, warmup=1, target_update=2)
T, B = 8, 6      # 48 transitions per step: the 64-slot ring wraps at step 2
SMALL_TRUNK = dict(name="small-trunk", family="dense", n_layers=2,
                   d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                   layer_pattern=(ATTN,))


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what):
    want = params_from_jax(_np(want))
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL,
                                   err_msg=f"{what} {k}")


def _noise(jag, js, key, kw):
    """The noise JAX's replay.sample draws from `key` in its learner_step,
    as the port's replay takes it."""
    cap, n = kw["replay_capacity"], kw["batch_size"]
    if not kw.get("prioritized", True):
        size = min(int(js.extra["replay"]["size"]) + T * B, cap)
        idx = jax.random.randint(key, (n,), 0, max(size, 1))
        return (np.asarray(idx, np.float32) + 0.5) / size
    fused = kw.get("fused_sampling", True)
    return np.asarray(jax.random.gumbel(key, (cap,) if fused else (n, cap)))


@pytest.mark.parametrize("extra", [
    {}, {"fused_sampling": False}, {"prioritized": False},
    {"double": False}], ids=["fused", "legacy", "uniform", "single_q"])
def test_learner_steps_match_jax(extra, deterministic):
    kw = dict(BASE, hidden=(16, 16), **extra)
    jenv = jenvs.make("cartpole")
    jag = jax_agents.make("dqn", env=jenv, ring_size=2, total_iters=10, **kw)
    tag = agent_api.make("dqn", env=envs.make("cartpole"), ring_size=2,
                         total_iters=10, device="cpu", **kw)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(0))
    js = jag.init(k_init)
    ts = train_state_from_jax(_np(js))
    for step in range(3):
        k_roll, k_learn = jax.random.split(jax.random.fold_in(k_run, step))
        jtraj, env_state = jax_rollout_fresh(
            jag.policy, jag.actor_policy(js, 0), jenv, k_roll, T, B)
        jboot = jax.vmap(jenv.obs)(env_state)
        noise = torch.tensor(_noise(jag, js, k_learn, kw))
        js, jm = jag.learner_step(js, jtraj, jboot, k_learn)
        ts, tm = tag.learner_step_noise(
            ts, {k: torch.tensor(np.asarray(v)) for k, v in jtraj.items()},
            torch.tensor(np.asarray(jboot)), noise)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  abs=1e-5, rel=1e-5)
        assert (float(tm["loss"]) == 0.0) == (step == 0)  # warmup
        _close(ts.params, js.params, f"step {step} params")
        for moment in ("m", "v"):
            _close(ts.opt_state[moment], js.opt_state[moment], moment)
        _close(ts.ring, js.ring, "ring")
        jr, tr = js.extra["replay"], ts.extra["replay"]
        for k in ("ptr", "size"):
            assert int(tr[k]) == int(jr[k])
        if "prio" in jr:
            np.testing.assert_allclose(tr["prio"].numpy(),
                                       np.asarray(jr["prio"]), **TOL)
        for k, v in jr["store"].items():
            np.testing.assert_allclose(tr["store"][k].numpy(), np.asarray(v))
        assert int(ts.steps) == int(js.steps) == step + 1
        assert int(ts.params["steps"]) == int(js.params["steps"]) == step
    # qsteps reached target_update = 2: the target net is the online net
    for k in ts.params:
        if k.startswith("target/"):
            assert torch.equal(ts.params[k], ts.params["online/" + k[7:]])


def test_trunk_q_net_learner_step(deterministic):
    """`policy="trunk"` makes the q-net the transformer trunk (its logits
    are the q-values): a learner step past warmup is finite, moves the
    online net, and the ring and optimizer state are keyed as the online
    net."""
    trunk = {"arch": ModelConfig(**SMALL_TRUNK), "reduced": False,
             "use_kernels": False}
    env = envs.make("cartpole")
    agent = agent_api.make("dqn", env=env, policy="trunk",
                           trunk_kwargs=trunk, total_iters=10, device="cpu",
                           **dict(BASE, warmup=0))
    state = agent.init(torch.Generator().manual_seed(0))
    online = sub(state.params, "online")
    assert any(k.startswith("lm/stack/1/") for k in online)
    assert set(state.ring) == set(online) == set(state.opt_state["m"])
    gen = torch.Generator().manual_seed(1)
    traj, env_state = rollout_fresh(agent.policy,
                                    agent.actor_policy(state, 0), env, gen,
                                    T, B)
    new, m = agent.learner_step(state, traj, env.obs(env_state), gen)
    assert torch.isfinite(m["loss"]) and float(m["loss"]) > 0
    moved = sum(float((new.params["online/" + k] - v).abs().sum())
                for k, v in online.items())
    assert moved > 0 and int(new.params["steps"]) == 1


def test_ring_from_jax_splits_blocks_per_slot():
    """A ring of stacked super-blocks has leaves (ring_size, repeats, ...):
    each slot's blocks split along repeats, the ring dim kept first."""
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((2, 3, 4)).astype(np.float32)
    head = rng.standard_normal((2, 5)).astype(np.float32)
    ring = ring_from_jax({"lm": {"stack": {"t0": {"w": blocks}}},
                          "pi": [{"w": head}]})
    assert set(ring) == {f"lm/stack/{r}/t0/w" for r in range(3)} | {
        "pi/0/w"}
    for r in range(3):
        np.testing.assert_array_equal(ring[f"lm/stack/{r}/t0/w"].numpy(),
                                      blocks[:, r])
    np.testing.assert_array_equal(ring["pi/0/w"].numpy(), head)


# ------------------------------------------------- (b) ε and _QPolicy
def test_epsilon_anneal_matches_jax():
    jenv = jenvs.make("cartpole")
    jag = jax_agents.make("dqn", env=jenv, total_iters=20, hidden=(8,))
    tag = agent_api.make("dqn", env=envs.make("cartpole"), total_iters=20,
                         hidden=(8,), device="cpu")
    assert tag.eps_decay_steps == jag.eps_decay_steps == 12
    js = jag.init(jax.random.PRNGKey(0))
    ts = train_state_from_jax(_np(js))
    for steps in (0, 1, 5, 11, 12, 40):
        js = dataclasses.replace(js, steps=jax.numpy.int32(steps))
        ts.steps = torch.tensor(steps, dtype=torch.int32)
        want = jag.actor_policy(js, 0)
        got = tag.actor_policy(ts, 0)
        assert float(got["eps"]) == float(want["eps"]), steps
        _close({k[4:]: v for k, v in got.items() if k != "eps"},
               want["net"], "net")


def test_qpolicy_sample_value_with_explicit_noise():
    """u0 < ε explores with floor(u1·n_actions), else greedy; log-prob
    under softmax(q) and value max q as JAX's `_QPolicy` computes them."""
    jenv = jenvs.make("cartpole")
    jag = jax_agents.make("dqn", env=jenv, hidden=(16,))
    tag = agent_api.make("dqn", env=envs.make("cartpole"), hidden=(16,),
                         device="cpu")
    js = jag.init(jax.random.PRNGKey(1))
    params = tag.actor_policy(train_state_from_jax(_np(js)), 0)
    params["eps"] = torch.tensor(0.5)
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((64, 4)).astype(np.float32)
    noise = rng.random((64, 2)).astype(np.float32)
    a, logp, v = tag.policy.sample_value(params, torch.tensor(obs),
                                         torch.tensor(noise))
    q = np.asarray(jag.policy.apply(jag.actor_policy(js, 0),
                                    jax.numpy.asarray(obs))[0])
    explore = noise[:, 0] < 0.5
    assert explore.any() and (~explore).any()
    want = np.where(explore, np.floor(noise[:, 1] * 2), q.argmax(-1)).astype(
        np.int64)
    np.testing.assert_array_equal(a.numpy(), want)
    assert a.dtype == torch.int32
    lsm = np.asarray(jax.nn.log_softmax(q))
    np.testing.assert_allclose(logp.numpy(), lsm[np.arange(64), want], **TOL)
    np.testing.assert_allclose(v.numpy(), q.max(-1), **TOL)
    tq, tv = tag.policy.apply(params, torch.tensor(obs))
    np.testing.assert_allclose(tq.numpy(), q, **TOL)
    assert torch.equal(tv, v)


def test_dqn_act_matches_jax_with_its_draws():
    """`DQN.act` takes the reference's two draws from its key (the random
    actions and the uniforms) as tensors and picks what it picks."""
    jag = jax_agents.make("dqn", env=jenvs.make("cartpole"), hidden=(16,))
    tag = agent_api.make("dqn", env=envs.make("cartpole"), hidden=(16,),
                         device="cpu")
    js = jag.init(jax.random.PRNGKey(2))
    obs = np.random.default_rng(1).standard_normal((64, 4)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    rand = jax.random.randint(key, (64,), 0, jag.dqn.n_actions)
    u = jax.random.uniform(key, (64,))
    assert (np.asarray(u) < 0.5).any() and (np.asarray(u) >= 0.5).any()
    want = jag.dqn.act(js.params, jax.numpy.asarray(obs), key, 0.5)
    got = tag.dqn.act(train_state_from_jax(_np(js)).params,
                      torch.tensor(obs), (torch.tensor(np.asarray(rand)),
                                          torch.tensor(np.asarray(u))), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("extra", [{}, {"prioritized": False}],
                         ids=["fused", "uniform"])
def test_dqn_learner_step_matches_jax(extra, deterministic):
    """`DQN.learner_step` (the algorithm class's own step on a filled
    replay) with the noise of the reference's key, twice: params, the
    adamw state, the replay and the loss; the second step syncs the
    target net (target_update = 2). The reference's jitted step draws its
    default 64 rows (its batch_size is not static)."""
    kw = dict(BASE, hidden=(16, 16), replay_capacity=128, **extra)
    jenv = jenvs.make("cartpole")
    jag = jax_agents.make("dqn", env=jenv, ring_size=2, total_iters=10, **kw)
    tag = agent_api.make("dqn", env=envs.make("cartpole"), ring_size=2,
                         total_iters=10, device="cpu", **kw)
    k_init, k_roll, k_learn = jax.random.split(jax.random.PRNGKey(4), 3)
    js = jag.init(k_init)
    jtraj, _ = jax_rollout_fresh(jag.policy, jag.actor_policy(js, 0), jenv,
                                 k_roll, 2 * T, B)
    jr = jag.replay.add_batch(js.extra["replay"], _np(
        tag.transitions({k: torch.tensor(np.asarray(v))
                         for k, v in jtraj.items()})))
    js = jax_agents.TrainState(js.params, js.opt_state, {"replay": jr},
                               js.ring, js.steps)
    ts = train_state_from_jax(_np(js))
    jp, jo, jrs = js.params, js.opt_state, jr
    tp, to, trs = ts.params, ts.opt_state, ts.extra["replay"]
    for key in jax.random.split(k_learn, 2):
        if kw.get("prioritized", True):
            noise = np.asarray(jax.random.gumbel(
                key, (kw["replay_capacity"],)))
        else:
            size = int(jrs["size"])
            idx = jax.random.randint(key, (64,), 0, size)
            noise = (np.asarray(idx, np.float32) + 0.5) / size
        jp, jo, jrs, jloss = jag.dqn.learner_step(jp, jo, jrs, key, jag.opt)
        tp, to, trs, tloss = tag.dqn.learner_step(tp, to, trs,
                                                  torch.tensor(noise),
                                                  tag.opt)
        assert float(tloss) == pytest.approx(float(jloss), abs=1e-5,
                                             rel=1e-5)
        _close(tp, jp, "params")
        for moment in ("m", "v"):
            _close(to[moment], jo[moment], moment)
        if "prio" in jrs:
            np.testing.assert_allclose(trs["prio"].numpy(),
                                       np.asarray(jrs["prio"]), **TOL)
    assert int(tp["steps"]) == int(jp["steps"]) == 2
    for k in tp:
        if k.startswith("target/"):
            assert torch.equal(tp[k], tp["online/" + k[7:]])


def test_train_state_from_jax_carries_the_replay():
    jag = jax_agents.make("dqn", env=jenvs.make("cartpole"), hidden=(8,),
                          replay_capacity=32)
    js = jag.init(jax.random.PRNGKey(0))
    ts = train_state_from_jax(_np(js))
    jr, tr = js.extra["replay"], ts.extra["replay"]
    assert set(tr) == {"store", "prio", "ptr", "size"}
    for k, v in jr["store"].items():
        assert tr["store"][k].shape == v.shape
        assert str(tr["store"][k].dtype).split(".")[-1] == str(v.dtype)
    assert tr["size"].dtype == torch.int32 and tr["prio"].shape == (32,)
    assert set(ts.params) == {f"{n}/{i}/{p}" for n in ("online", "target")
                              for i in range(2) for p in "wb"} | {"steps"}


# ------------------------------------------------ (c) Trainer
def _hist_equal(h1, h2):
    return len(h1) == len(h2) and all(
        r1.keys() == r2.keys() and all(
            r1[k] == r2[k] or (np.isnan(r1[k]) and np.isnan(r2[k]))
            for k in r1) for r1, r2 in zip(h1, h2))


def test_fused_equals_unfused_bitwise():
    cfg = TrainerConfig(algo="dqn", iters=8, superstep=4, n_envs=8,
                        unroll=8, log_every=2, seed=1,
                        algo_kwargs={"hidden": (16,), "warmup": 2,
                                     "replay_capacity": 128,
                                     "target_update": 3})
    env = envs.make("cartpole")
    s_f, h_f = Trainer(env, cfg, device="cpu").fit(fused=True)
    s_u, h_u = Trainer(env, cfg, device="cpu").fit(fused=False)
    for k in s_f.params:
        assert torch.equal(s_f.params[k], s_u.params[k]), k
    assert torch.equal(s_f.extra["replay"]["prio"],
                       s_u.extra["replay"]["prio"])
    assert int(s_f.params["steps"]) == 6 and int(s_f.steps) == 8
    assert _hist_equal(h_f, h_u)
    assert all(np.isfinite(h["loss"]) for h in h_f)


def test_trainer_dqn_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(envs.make("cartpole"), TrainerConfig(algo="dqn"))


# --------------------------------------------- (d) CLI and serving
def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_trains_dqn():
    out = _run(rl_train.main, ["--device", "cpu", "--algo", "dqn",
                               "--iters", "10", "--superstep", "5",
                               "--n-envs", "4", "--unroll", "8",
                               "--log-every", "3"])
    assert out["algo"] == "dqn" and out["device"] == "cpu"
    assert [h["iter"] for h in out["history"]] == [0, 3, 6, 9]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["history"][-1]["loss"] > 0  # past the 8 warmup iterations


def test_served_dqn_batch_is_sample_value():
    """ServeEngine on DQN behavior params (with ε) gives, row for row,
    `_QPolicy.sample_value` on the same params and request noise."""
    agent = agent_api.make("dqn", env=envs.make("cartpole"), hidden=(16,),
                           total_iters=10, device="cpu")
    state = agent.init(torch.Generator().manual_seed(0))
    state.steps = torch.tensor(4, dtype=torch.int32)
    store = ParamStore()
    store.publish_from_state(agent, state)
    _, params = store.get()
    assert 0.05 < float(params["eps"]) < 1.0
    engine = ServeEngine(agent.policy, envs.make("cartpole").spec.observation,
                         buckets=(8,), store=store, seed=5, device="cpu")
    obs = np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32)
    a, logp, v = engine.eval_bucket(list(obs), range(6), 8)
    noise = torch.tensor(agent.policy.request_noise(5, range(6)))
    wa, wl, wv = agent.policy.sample_value(params, torch.tensor(obs), noise)
    assert torch.equal(a, wa) and torch.equal(logp, wl)
    assert torch.equal(v, wv)


def test_jax_dqn_archive_serves_its_ring_slot_and_epsilon(tmp_path):
    """A JAX DQN Trainer archive: the served params are its `.ring/` slot
    0 and the ε of its archived `steps`, as JAX's actor_policy gives."""
    from repro.core.trainer import Trainer as JaxTrainer
    from repro.core.trainer import TrainerConfig as JaxConfig
    cfg = JaxConfig(algo="dqn", iters=3, superstep=1, n_envs=4, unroll=4,
                    seed=0, log_every=1,
                    algo_kwargs={"warmup": 1, "replay_capacity": 64})
    jtr = JaxTrainer(jenvs.make("cartpole"), cfg)
    js, _ = jtr.fit()
    path = jax_save(str(tmp_path / "dqn.npz"), js)
    ts = load_train_state(path, device="cpu")
    assert int(ts.steps) == 3
    # the serving CLI's agent: total_iters = --train-iters (default 20)
    jag = jax_agents.make("dqn", env=jenvs.make("cartpole"), total_iters=20)
    tag = agent_api.make("dqn", env=envs.make("cartpole"), total_iters=20,
                         device="cpu")
    want, got = jag.actor_policy(js, 0), tag.actor_policy(ts, 0)
    assert float(got["eps"]) == float(want["eps"]) < 1.0
    _close({k[4:]: v for k, v in got.items() if k != "eps"}, want["net"],
           "net")
    out = _run(serve_policy.main, ["--device", "cpu", "--algo", "dqn",
                                   "--ckpt", path, "--load", "4000",
                                   "--buckets", "4", "--requests", "12",
                                   "--out", str(tmp_path)])
    assert out["source"] == "checkpoint" and out["algo"] == "dqn"
    assert out["recompiles_after_warmup"] == 0 and out["hot_swaps"] == 1


@pytest.mark.parametrize("train_iters", ["0", "2"])
def test_serve_cli_runs_dqn(train_iters, tmp_path):
    out = _run(serve_policy.main, ["--device", "cpu", "--algo", "dqn",
                                   "--train-iters", train_iters,
                                   "--load", "4000", "--buckets", "4",
                                   "--requests", "12",
                                   "--out", str(tmp_path)])
    assert out["source"] == ("fresh-init" if train_iters == "0"
                             else "trained-in-process")
    assert out["recompiles_after_warmup"] == 0 and out["hot_swaps"] == 1
