"""The port's single-device training path (repro_torch.core.{rollout,
agent,algos,trainer} and launch/rl_train) on the CPU:

  (a) the rollout contract: time-major shapes and dtypes as the JAX
      rollout's, `next_obs` the terminal obs at a done step, one policy
      forward per step;
  (b) one `learner_step` for ppo, a3c and impala on cartpole and ppo on
      pendulum (a continuous head) against the JAX agent, from the same
      TrainState (`train_state_from_jax`), the same trajectory (a JAX
      rollout) and the same PPO permutations: params, optimizer moments,
      ring and loss within 1e-5 (f32 sums in another order); the same for
      ppo, a3c, impala and dqn (its replay draw's noise from the JAX key,
      through `learner_step_noise`) with a small transformer trunk as the
      policy, `use_kernels=True` (the plain attention on CPU tensors, as
      the reference's oracle off the TPU). A3C keeps
      the gradient through its n-step target into the bootstrap value;
      The algorithm classes' own steps, `PPO.update` and
      `IMPALA.learner_step`, on one batch against the reference's;
  (c) exact episode accounting, the cases of tests/test_trainer.py;
  (d) fused and unfused fits bitwise equal;
  (e) the lag ring under `policy_lag`;
  (f) V-trace >= 0.6 x naive under policy_lag=4, as the reference;
  (g) ppo, a3c, impala finite and learning (> 0) on cartpole;
  (h) the CLI's JSON line and its refusals.
"""
import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

import repro.envs as jenvs
import repro_torch.envs as envs
from repro.core import agent as jax_agents
from repro.core.rollout import rollout_fresh as jax_rollout_fresh
from repro.configs.base import ModelConfig as JaxModelConfig
from repro_torch.checkpoint.convert import (params_from_jax, ring_from_jax,
                                            train_state_from_jax)
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.core import agent as agent_api
from repro_torch.core.distribution import DistPlan
from repro_torch.core.rollout import rollout, rollout_fresh
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.launch import rl_train

TOL = dict(atol=1e-5, rtol=1e-5)
HIDDEN = (16, 16)
# a small trunk (tests/test_torch_trunk.py's): 2 layers, d_model 32,
# 4 query heads over 2 kv heads, head dim 8
SMALL_TRUNK = dict(name="small-trunk", family="dense", n_layers=2,
                   d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                   layer_pattern=(ATTN,))
TRUNK = {"policy": "trunk"}
DQN_KW = dict(replay_capacity=64, batch_size=16, warmup=0,
              target_update=2, total_iters=10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_traj(traj):
    return {k: torch.tensor(np.asarray(v)) for k, v in traj.items()}


# ------------------------------------------------------ (a) the rollout
def test_rollout_contract():
    env = envs.make("cartpole")
    ag = agent_api.make("ppo", env=env, hidden=(8,), device="cpu")
    params = ag.policy.init(torch.Generator().manual_seed(0))
    calls = []
    apply = ag.policy.apply
    ag.policy.apply = lambda *a: calls.append(1) or apply(*a)
    T, B = 40, 6
    traj, _ = rollout_fresh(ag.policy, params, env,
                            torch.Generator().manual_seed(1), T, B)
    del ag.policy.apply
    assert len(calls) == T  # one forward per step
    jenv = jenvs.make("cartpole")
    jag = jax_agents.make("ppo", env=jenv, hidden=(8,))
    jtraj, _ = jax_rollout_fresh(jag.policy, jag.init(jax.random.PRNGKey(0))
                                 .params, jenv, jax.random.PRNGKey(1), T, B)
    for k, v in traj.items():
        assert tuple(v.shape) == jtraj[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(jtraj[k].dtype), k
    done = traj["done"][:-1]
    assert done.any() and (~done).any()
    same = (traj["next_obs"][:-1] == traj["obs"][1:]).all(-1)
    assert bool(same[~done].all())      # successor obs within an episode
    assert not bool(same[done].any())   # terminal obs, not the reset one


# ------------------------------------------- (b) learner_step parity
def _step_pair(name, env_name, T=8, B=6, seed=0, algo_kwargs=None):
    """(JAX state after one learner_step, its loss, port state, loss)
    from one JAX init, rollout and key."""
    kw = dict(hidden=HIDDEN, **(algo_kwargs or {}))
    tkw = dict(kw)
    if kw.get("policy") == "trunk":
        kw["trunk_kwargs"] = {"arch": JaxModelConfig(**SMALL_TRUNK),
                              "reduced": False, "use_kernels": True}
        tkw["trunk_kwargs"] = {"arch": ModelConfig(**SMALL_TRUNK),
                               "reduced": False, "use_kernels": True}
    jenv = jenvs.make(env_name)
    jag = jax_agents.make(name, env=jenv, ring_size=2, **kw)
    key = jax.random.PRNGKey(seed)
    k_init, k_roll, k_learn = jax.random.split(key, 3)
    jstate = jag.init(k_init)
    jtraj, env_state = jax_rollout_fresh(
        jag.policy, jag.actor_policy(jstate, 0), jenv, k_roll, T, B)
    jboot = jax.vmap(jenv.obs)(env_state)
    tstate = train_state_from_jax(_np(jstate))
    tag = agent_api.make(name, env=envs.make(env_name), ring_size=2,
                         device="cpu", **tkw)
    traj, boot = _torch_traj(jtraj), torch.tensor(np.asarray(jboot))
    jnew, jm = jag.learner_step(jstate, jtraj, jboot, k_learn)
    if name == "dqn":  # the fused draw's Gumbel noise from JAX's key
        noise = jax.random.gumbel(k_learn, (kw["replay_capacity"],))
        tnew, tm = tag.learner_step_noise(tstate, traj, boot,
                                          torch.tensor(np.asarray(noise)))
    elif name == "ppo":
        keys = jax.random.split(k_learn, tag.n_epochs)
        perms = np.stack([np.asarray(jax.random.permutation(k, T * B))
                          for k in keys])
        tnew, tm = tag.learner_step_perms(tstate, traj, boot,
                                          torch.tensor(perms))
    else:
        tnew, tm = tag.learner_step(tstate, traj, boot)
    return jnew, float(jm["loss"]), tnew, float(tm["loss"])


@pytest.mark.parametrize("name,env_name,algo_kwargs", [
    ("ppo", "cartpole", None), ("a3c", "cartpole", None),
    ("impala", "cartpole", None), ("ppo", "pendulum", None),
    ("impala", "cartpole", {"use_vtrace": False}),
    ("impala", "pendulum", {"use_eps_correction": True}),
    ("ppo", "cartpole", TRUNK), ("a3c", "cartpole", TRUNK),
    ("impala", "cartpole", TRUNK),
    ("dqn", "cartpole", dict(TRUNK, **DQN_KW))])
def test_learner_step_matches_jax(name, env_name, algo_kwargs):
    jnew, jloss, tnew, tloss = _step_pair(name, env_name,
                                          algo_kwargs=algo_kwargs)
    assert tloss == pytest.approx(jloss, abs=1e-5, rel=1e-5)
    want = params_from_jax(_np(jnew.params))
    assert set(want) == set(tnew.params)
    for k, v in want.items():
        np.testing.assert_allclose(tnew.params[k].numpy(), v.numpy(), **TOL,
                                   err_msg=k)
    for moment in ("m", "v"):
        jm = params_from_jax(_np(jnew.opt_state[moment]))
        for k, v in jm.items():
            np.testing.assert_allclose(tnew.opt_state[moment][k].numpy(),
                                       v.numpy(), **TOL, err_msg=k)
    ring = ring_from_jax(_np(jnew.ring))
    assert set(ring) == set(tnew.ring)
    for k, v in ring.items():
        np.testing.assert_allclose(tnew.ring[k].numpy(), v.numpy(), **TOL)
    assert int(tnew.steps) == int(jnew.steps) == 1
    assert int(tnew.opt_state["step"]) == int(jnew.opt_state["step"])


def _algo_pair(name):
    """The JAX and port agents (cartpole, HIDDEN), one JAX state with its
    port copy, and a JAX rollout as both take it."""
    jenv = jenvs.make("cartpole")
    jag = jax_agents.make(name, env=jenv, hidden=HIDDEN)
    tag = agent_api.make(name, env=envs.make("cartpole"), hidden=HIDDEN,
                         device="cpu")
    k_init, k_roll, k_learn = jax.random.split(jax.random.PRNGKey(3), 3)
    jstate = jag.init(k_init)
    jtraj, env_state = jax_rollout_fresh(
        jag.policy, jag.actor_policy(jstate, 0), jenv, k_roll, 8, 6)
    jboot = jax.vmap(jenv.obs)(env_state)
    return (jag, tag, jstate, train_state_from_jax(_np(jstate)), jtraj,
            jboot, k_learn)


def _assert_step(tparams, topt, tloss, jparams, jopt, jloss):
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5, rel=1e-5)
    for got, want in ((tparams, jparams), (topt["m"], jopt["m"]),
                      (topt["v"], jopt["v"])):
        want = params_from_jax(_np(want))
        assert set(want) == set(got)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL,
                                       err_msg=k)
    assert int(topt["step"]) == int(jopt["step"])


def test_ppo_update_matches_jax():
    """`PPO.update` (the algorithm class's own epoch/minibatch loop) on
    one flattened batch, with the permutations the reference draws from
    its key."""
    jag, tag, jstate, tstate, jtraj, jboot, key = _algo_pair("ppo")
    jbatch = jag.algo.make_batch(jstate.params, jtraj, jboot)
    n_epochs, n_mb = 2, 3
    n = jbatch["obs"].shape[0]
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in jax.random.split(key, n_epochs)])
    jparams, jopt, jloss = jag.algo.update(
        jstate.params, jstate.opt_state, jbatch, key, jag.opt,
        n_epochs=n_epochs, n_minibatch=n_mb)
    tparams, topt, tloss = tag.algo.update(
        tstate.params, tstate.opt_state, _torch_traj(jbatch),
        torch.tensor(perms), tag.opt, n_epochs=n_epochs, n_minibatch=n_mb)
    _assert_step(tparams, topt, tloss, jparams, jopt, jloss)
    with pytest.raises(ValueError, match="rows"):
        tag.algo.update(tstate.params, tstate.opt_state,
                        _torch_traj(jbatch), torch.tensor(perms), tag.opt,
                        n_epochs=3)


def test_impala_learner_step_matches_jax():
    """`IMPALA.learner_step` (one gradient of the V-trace loss and the
    optimizer) on one trajectory."""
    jag, tag, jstate, tstate, jtraj, jboot, _ = _algo_pair("impala")
    jparams, jopt, jloss = jag.algo.learner_step(
        jstate.params, jstate.opt_state, jtraj, jboot, jag.opt)
    tparams, topt, tloss = tag.algo.learner_step(
        tstate.params, tstate.opt_state, _torch_traj(jtraj),
        torch.tensor(np.asarray(jboot)), tag.opt)
    _assert_step(tparams, topt, tloss, jparams, jopt, jloss)


def test_a3c_gradient_reaches_the_bootstrap_value():
    """The n-step target keeps its gradient into V(boot_obs): the loss has
    a non-zero gradient with respect to the bootstrap observation, which
    it reaches only through the target (a3c.py:40-44)."""
    env = envs.make("cartpole")
    ag = agent_api.make("a3c", env=env, hidden=HIDDEN, device="cpu")
    params = ag.policy.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    traj, env_state = rollout_fresh(ag.policy, params, env, gen, 8, 6)
    boot_obs = env.obs(env_state).clone().requires_grad_()
    (g,) = torch.autograd.grad(ag.algo.loss(params, traj, boot_obs),
                               boot_obs)
    assert float(g.abs().sum()) > 1e-4


# ------------------------------------------- (c) episode accounting
def test_episode_accounting_exact_and_carried():
    run0 = torch.zeros((2,))
    nan = torch.full((), float("nan"))
    rew = torch.ones((3, 2))
    none_done = torch.zeros((3, 2), dtype=torch.bool)
    run, ret = Trainer._episode_stats(run0, nan, {"reward": rew,
                                                  "done": none_done})
    assert np.isnan(float(ret))
    np.testing.assert_allclose(run, [3.0, 3.0])
    done = torch.tensor([[False, False], [True, False], [False, False]])
    run, ret = Trainer._episode_stats(run, ret, {"reward": rew,
                                                 "done": done})
    assert float(ret) == pytest.approx(5.0)
    np.testing.assert_allclose(run, [1.0, 6.0])
    run, ret = Trainer._episode_stats(run, ret, {"reward": rew,
                                                 "done": none_done})
    assert float(ret) == pytest.approx(5.0)
    np.testing.assert_allclose(run, [4.0, 9.0])
    done2 = torch.tensor([[True, True], [False, False], [False, False]])
    _, ret = Trainer._episode_stats(run, ret, {"reward": rew,
                                               "done": done2})
    assert float(ret) == pytest.approx(((4 + 1) + (9 + 1)) / 2)


# ------------------------------------- (d) fused == unfused, bitwise
def _hist_equal(h1, h2):
    return len(h1) == len(h2) and all(
        r1.keys() == r2.keys() and all(
            r1[k] == r2[k] or (np.isnan(r1[k]) and np.isnan(r2[k]))
            for k in r1) for r1, r2 in zip(h1, h2))


def test_fused_equals_unfused_bitwise():
    cfg = TrainerConfig(algo="impala", iters=8, superstep=4, n_envs=8,
                        unroll=8, log_every=4, seed=1,
                        algo_kwargs={"hidden": (16,)})
    env = envs.make("cartpole")
    s_f, h_f = Trainer(env, cfg, device="cpu").fit(fused=True)
    s_u, h_u = Trainer(env, cfg, device="cpu").fit(fused=False)
    for k in s_f.params:
        assert torch.equal(s_f.params[k], s_u.params[k]), k
        assert torch.equal(s_f.opt_state["m"][k], s_u.opt_state["m"][k])
    assert [r["iter"] for r in h_f] == [0, 4, 7]
    assert _hist_equal(h_f, h_u)


# ------------------------------------------------ (e) the lag ring
def test_ring_rotation_tracks_policy_lag():
    env = envs.make("cartpole")
    ag = agent_api.make("impala", env=env, ring_size=2, hidden=(8,),
                        device="cpu")
    state = ag.init(torch.Generator().manual_seed(0))
    stale = ag.actor_policy(state, 99)  # clipped to the ring depth
    for k in state.params:
        assert torch.equal(stale[k], state.params[k])
    old = dict(state.params)
    gen = torch.Generator().manual_seed(1)
    traj, env_state = rollout(ag.policy, ag.actor_policy(state, 0), env,
                              gen, env.reset(gen, 4), 4)
    state, metrics = ag.learner_step(state, traj, env.obs(env_state), gen)
    assert torch.isfinite(metrics["loss"])
    lagged = ag.actor_policy(state, 1)
    for k in old:
        assert torch.equal(lagged[k], old[k])
    newest = ag.actor_policy(state, 0)
    assert sum(float((newest[k] - old[k]).abs().sum()) for k in old) > 0
    assert all(torch.equal(newest[k], state.params[k]) for k in old)


def test_trainer_lag_reads_the_ring():
    """With policy_lag=2 the ring holds 3 slots and the rollout acts with
    the slot two updates old."""
    cfg = TrainerConfig(algo="a3c", iters=3, n_envs=4, unroll=4,
                        policy_lag=2, algo_kwargs={"hidden": (8,)})
    tr = Trainer(envs.make("cartpole"), cfg, device="cpu")
    assert tr.agent.ring_size == 3
    seen = []
    read = tr.agent.actor_policy
    tr.agent.actor_policy = lambda s, d=0: seen.append(d) or read(s, d)
    tr.fit()
    assert seen == [2, 2, 2]


# ---------------------------------- (f) V-trace under policy lag
def test_impala_policy_lag_vtrace_beats_naive():
    env = envs.make("cartpole")
    rets = {}
    for use_vtrace in (True, False):
        cfg = TrainerConfig(algo="impala", iters=40, superstep=10,
                            n_envs=16, unroll=16, policy_lag=4, seed=3,
                            log_every=40,
                            algo_kwargs={"hidden": (32,),
                                         "use_vtrace": use_vtrace})
        _, hist = Trainer(env, cfg, device="cpu").fit()
        rets[use_vtrace] = hist[-1]["episode_return"]
    assert rets[True] >= 0.6 * rets[False], rets


# -------------------------------------------- (g) learning sanity
@pytest.mark.parametrize("algo", ["ppo", "a3c", "impala"])
def test_fit_is_finite_and_learns(algo):
    cfg = TrainerConfig(algo=algo, iters=6, superstep=3, n_envs=8,
                        unroll=16, log_every=1,
                        algo_kwargs={"hidden": (16,)})
    state, hist = Trainer(envs.make("cartpole"), cfg, device="cpu").fit()
    assert len(hist) == 6 and all(np.isfinite(h["loss"]) for h in hist)
    assert np.isfinite(hist[-1]["episode_return"])
    assert hist[-1]["episode_return"] > 0
    assert int(state.steps) == 6
    assert all(torch.isfinite(p).all() for p in state.params.values())


def test_trainer_refuses_later_slices():
    """The ZeRO-2 plan and the pipelined mode this test once saw refused
    (ROADMAP queue 1, items 12 and 11) now run."""
    env = envs.make("cartpole")
    small = dict(iters=2, superstep=2, n_envs=8, unroll=4,
                 algo_kwargs={"hidden": (8,)})
    tr = Trainer(env, TrainerConfig(plan=DistPlan.zero(1, 2), **small),
                 device="cpu")
    _, hist = tr.fit()
    assert tr.partition["n_shards"] == 2 and np.isfinite(hist[-1]["loss"])
    tr = Trainer(env, TrainerConfig(pipeline=True, **small), device="cpu")
    _, hist = tr.fit()
    assert (tr.pipeline_depth, tr.pipeline_capacity) == (0, 1)
    assert np.isfinite(hist[-1]["loss"])


def test_trainer_runs_two_workers():
    cfg = TrainerConfig(algo="ppo", iters=3, superstep=2, n_envs=8,
                        unroll=8, plan=DistPlan.flat(2), log_every=1,
                        algo_kwargs={"hidden": (8,)})
    state, hist = Trainer(envs.make("cartpole"), cfg, device="cpu").fit()
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert int(state.steps) == 3


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(envs.make("cartpole"), TrainerConfig(algo="ppo"))


# ----------------------------------------------------------- (h) CLI
def _run_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rl_train.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("algo", ["ppo", "a3c", "impala"])
def test_cli_prints_the_json_line(algo):
    out = _run_cli(["--device", "cpu", "--algo", algo, "--iters", "3",
                    "--superstep", "2", "--n-envs", "4", "--unroll", "8",
                    "--log-every", "1"])
    assert out["algo"] == algo and out["device"] == "cpu"
    assert out["plan"] == "workers=1:allreduce:bsp"
    assert out["n_devices"] == 1 and out["fused"] is True
    assert out["actor_shards"] == [4, 4]
    assert [h["iter"] for h in out["history"]] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in out["history"])


@pytest.mark.parametrize("flags,n_devices,shards", [
    (["--plan", "workers=2:allreduce:bsp"], 2, [8, 8]),
    (["--actors", "8,16"], 1, [8, 16]), (["--n-workers", "2"], 2, [8, 8]),
    (["--sync", "asp", "--n-workers", "2"], 2, [8, 8]),
    # refused by name until the pipeline and sharded learner-state slices
    (["--pipeline"], 1, [8, 8]),
    (["--plan", "workers=1,shard=2:allreduce:bsp:shard"], 2, [8, 8]),
    (["--plan", "workers=2,zero3=2:allreduce:bsp:zero3"], 4, [8, 8])])
def test_cli_runs_what_this_slice_brings(flags, n_devices, shards):
    out = _run_cli(["--device", "cpu", "--algo", "a3c", "--iters", "4",
                    "--superstep", "2", "--n-envs", "8", "--unroll", "8",
                    "--log-every", "1"] + flags)
    assert out["n_devices"] == n_devices and out["actor_shards"] == shards
    assert len(out["history"]) == 4
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["pipeline"] is ("--pipeline" in flags)
    assert (out["pipeline_depth"], out["pipeline_capacity"]) == (
        (0, 1) if "--pipeline" in flags else (0, None))
    role = flags[-1].rsplit(":", 1)[-1] if "--plan" in flags else "data"
    if role in ("shard", "zero3"):
        axis = flags[-1].split(",")[1].split("=")[0]
        assert out["partition"]["axis"] == axis
        assert out["partition"]["n_shards"] == 2
        assert ("entries" in out["partition"]) is (role == "zero3")
    else:
        assert out["partition"] is None


@pytest.mark.parametrize("flags,frag", [
    (["--env", "no-such-env"], "registered")])
def test_cli_refuses_what_later_slices_bring(flags, frag, capsys):
    with pytest.raises(SystemExit) as exc:
        rl_train.main(["--device", "cpu"] + flags)
    assert exc.value.code == 2
    assert frag in capsys.readouterr().err
