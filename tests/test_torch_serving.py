"""The port's serving subsystem (repro_torch.core.serving and
launch/serve_policy) on the CPU: the contracts of tests/test_serving.py
(versions, template drift, in-flight snapshots, buckets, FIFO, arrival
times, per-request bitwise bucket parity, hot swap without a rebuild,
version tags), parity with the JAX ServeEngine on the same params and
rows (`ServeEngine.for_agent` and `RequestBatcher.next_arrival`
against the reference's too), the CLI, and the refusal to run on the
CPU unasked.

Values are held to f32 atol = rtol = 2e-5 against JAX (the same math
summed in another order); everything inside the port is bitwise."""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as jenvs
import repro_torch.envs as envs
from repro.configs.base import ATTN as JAX_ATTN
from repro.configs.base import ModelConfig as JaxConfig
from repro.core.networks import MLPPolicy as JaxMLP
from repro.core.networks import TrunkPolicy as JaxTrunk
from repro.core.serving import ParamStore as JaxStore
from repro.core.serving import ServeEngine as JaxEngine
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.core.networks import MLPPolicy, TrunkPolicy
from repro_torch.core.serving import (ParamStore, RequestBatcher,
                                      ServeEngine, bucket_for,
                                      validate_buckets)
from repro_torch.launch import serve_policy

TOL = dict(atol=2e-5, rtol=2e-5)


def _mlp_engine(env_name="cartpole", buckets=(8,), seed=3, hidden=(16,)):
    env = envs.make(env_name)
    policy = MLPPolicy.for_spec(env.spec, hidden=hidden, device="cpu")
    store = ParamStore()
    store.publish(policy.init(torch.Generator().manual_seed(0)))
    return env, ServeEngine(policy, env.spec.observation, buckets=buckets,
                            store=store, seed=seed, device="cpu")


def _obs_rows(env, n, seed=7):
    return list(env.spec.observation.sample(
        torch.Generator().manual_seed(seed), n).numpy())


def _scaled(params, factor):
    return {k: v * factor for k, v in params.items()}


# ------------------------------------------------------------ ParamStore
def test_param_store_versions_are_monotonic():
    store = ParamStore()
    assert store.version == 0
    p = {"w": torch.ones((2, 2))}
    assert store.publish(p) == 1
    assert store.publish(p) == 2
    v, got = store.get()
    assert v == 2 and torch.equal(got["w"], p["w"])


def test_param_store_empty_get_raises():
    with pytest.raises(RuntimeError, match="publish"):
        ParamStore().get()


def test_param_store_rejects_shape_and_tree_drift():
    store = ParamStore()
    store.publish({"w": torch.ones((2, 2)), "b": torch.zeros((2,))})
    with pytest.raises(ValueError, match="recompile"):
        store.publish({"w": torch.ones((3, 2)), "b": torch.zeros((2,))})
    with pytest.raises(ValueError, match="treedef"):
        store.publish({"w": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="'w'"):
        store.publish({"w": torch.ones((2, 2), dtype=torch.int32),
                       "b": torch.zeros((2,))})
    assert store.version == 1  # the failed publishes never became versions


def test_in_flight_snapshot_survives_publish():
    env, engine = _mlp_engine()
    obs = _obs_rows(env, 3)
    v1, p1 = engine.store.get()
    before = engine.eval_bucket(obs, [0, 1, 2], 8, params=p1)
    engine.store.publish(_scaled(p1, 2.0))
    after = engine.eval_bucket(obs, [0, 1, 2], 8, params=p1)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert engine.store.version == v1 + 1


# -------------------------------------------------------- bucket grammar
def test_bucket_for_picks_smallest_fitting_bucket():
    assert bucket_for(1, (4, 16)) == 4
    assert bucket_for(4, (4, 16)) == 4
    assert bucket_for(5, (4, 16)) == 16
    assert bucket_for(16, (4, 16)) == 16
    with pytest.raises(ValueError, match="largest bucket"):
        bucket_for(17, (4, 16))
    with pytest.raises(ValueError, match="empty"):
        bucket_for(0, (4, 16))


@pytest.mark.parametrize("bad,frag", [((), "at least one"), ((0,), "positive"),
                                      ((4, 4), "increasing"),
                                      ((8, 2), "increasing")])
def test_validate_buckets_rejects_bad_grammars(bad, frag):
    assert validate_buckets((1, 4, 16)) == (1, 4, 16)
    with pytest.raises(ValueError, match=frag):
        validate_buckets(bad)


# ------------------------------------------------------- RequestBatcher
def test_batcher_fifo_and_never_drops():
    b = RequestBatcher()
    ids = [b.submit(i) for i in range(37)]
    assert ids == list(range(37))
    seen = []
    while len(b):
        chunk = b.take(8)
        assert len(chunk) <= 8
        seen.extend(r["id"] for r in chunk)
    assert seen == ids


def test_batcher_take_respects_arrival_times():
    b = RequestBatcher()
    b.submit("a", arrival=1.0)
    b.submit("b", arrival=5.0)
    b.submit("c", arrival=2.0)  # behind b: FIFO order, not arrival sort
    assert [r["obs"] for r in b.take(8, now=0.5)] == []
    assert [r["obs"] for r in b.take(8, now=1.5)] == ["a"]
    assert [r["obs"] for r in b.take(8, now=2.5)] == []
    assert [r["obs"] for r in b.take(8, now=6.0)] == ["b", "c"]
    assert len(b) == 0


def test_batcher_next_arrival_matches_jax():
    """The oldest queued request's arrival (None when empty), as the
    reference's batcher reports it through submits and takes."""
    from repro.core.serving import RequestBatcher as JaxBatcher
    tb, jb = RequestBatcher(), JaxBatcher()
    assert tb.next_arrival() is None and jb.next_arrival() is None
    for obs, t in (("a", 3.0), ("b", 1.0), ("c", 2.0)):
        tb.submit(obs, arrival=t)
        jb.submit(obs, arrival=t)
    seen = []
    for now in (0.5, 3.5, 3.5, 3.5):
        assert tb.next_arrival() == jb.next_arrival()
        seen.append(tb.next_arrival())
        tb.take(1, now=now)
        jb.take(1, now=now)
    assert seen == [3.0, 3.0, 1.0, 2.0]
    assert tb.next_arrival() is None and jb.next_arrival() is None


def test_engine_for_agent_matches_jax():
    """`ServeEngine.for_agent`: the agent's rollout policy and the env's
    observation space; served on the same params it answers as the
    reference's `for_agent` engine does (values within TOL, the same
    actions' log-probs)."""
    from repro.core import agent as jax_agents
    from repro_torch.core import agent as agent_api
    jenv, env = jenvs.make("cartpole"), envs.make("cartpole")
    jag = jax_agents.make("ppo", env=jenv, hidden=(16,))
    tag = agent_api.make("ppo", env=env, hidden=(16,), device="cpu")
    jeng = JaxEngine.for_agent(jag, jenv, buckets=(8,), seed=4)
    teng = ServeEngine.for_agent(tag, env, buckets=(8,), seed=4,
                                 device="cpu")
    assert teng.policy is tag.policy
    assert teng.obs_space == env.spec.observation
    assert teng.buckets == jeng.buckets == (8,)
    jparams = jag.policy.init(jax.random.PRNGKey(2))
    jeng.store.publish(jparams)
    teng.store.publish(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jparams)))
    obs = _obs_rows(env, 5, seed=3)
    _, _, v_j = jeng.eval_bucket([jnp.asarray(o) for o in obs],
                                 list(range(5)), 8)
    a_t, l_t, v_t = teng.eval_bucket(obs, list(range(5)), 8)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **TOL)
    pi, _ = jag.policy.apply(jparams, jnp.asarray(np.stack(obs)))
    want = jax.nn.log_softmax(pi)[np.arange(5), a_t.numpy()]
    np.testing.assert_allclose(l_t.numpy(), np.asarray(want), **TOL)


def test_engine_fifo_fairness_under_bucketed_dispatch():
    env, engine = _mlp_engine(buckets=(2, 4))
    ids = [engine.submit(o) for o in _obs_rows(env, 11)]
    assert [r["id"] for r in engine.drain()] == ids
    assert sorted(engine.results) == ids
    obs = _obs_rows(env, 5, seed=8)
    actions = engine.serve(obs)  # the synchronous convenience, in order
    assert actions.shape == (5,)
    np.testing.assert_array_equal(
        actions, [engine.results[i]["action"] for i in range(11, 16)])


# ------------------------------------------------------- bucket parity
@pytest.mark.parametrize("name", envs.available())
def test_bucket_parity_per_request_bitwise(name):
    """Row i of a padded bucket-of-8 dispatch is bitwise row i of a
    single-request dispatch in the same bucket."""
    env, engine = _mlp_engine(name)
    obs = _obs_rows(env, 6)
    a_b, l_b, v_b = engine.eval_bucket(obs, list(range(6)), 8)
    for i in range(6):
        a_1, l_1, v_1 = engine.eval_bucket([obs[i]], [i], 8)
        assert torch.equal(a_b[i], a_1[0])
        assert torch.equal(l_b[i], l_1[0])
        assert torch.equal(v_b[i], v_1[0])


def test_trunk_bucket_parity_per_request_bitwise():
    spec = envs.make("cartpole").spec
    policy = TrunkPolicy.for_spec(spec, device="cpu")
    store = ParamStore()
    store.publish(policy.init(torch.Generator().manual_seed(0)))
    engine = ServeEngine(policy, spec.observation, buckets=(4,),
                         store=store, seed=1, device="cpu")
    obs = _obs_rows(envs.make("cartpole"), 3)
    batch = engine.eval_bucket(obs, [5, 6, 7], 4)
    for i in range(3):
        one = engine.eval_bucket([obs[i]], [5 + i], 4)
        for b, o in zip(batch, one):
            assert torch.equal(b[i], o[0])


def test_response_depends_only_on_seed_id_and_params():
    env, e1 = _mlp_engine(seed=9)
    _, e2 = _mlp_engine(seed=9)
    obs = _obs_rows(env, 4)
    r1 = e1.eval_bucket(obs, [10, 11, 12, 13], 8)
    r2 = e2.eval_bucket(obs[2:3], [12], 8)
    assert torch.equal(r1[0][2], r2[0][0])
    _, e3 = _mlp_engine(seed=10)
    draws = [e.policy.request_noise(e.seed, range(64))
             for e in (e1, e2, e3)]
    np.testing.assert_array_equal(draws[0], draws[1])
    assert not np.array_equal(draws[0], draws[2])


# -------------------------------------------- hot swap without a rebuild
def test_hot_swap_and_batch_size_variation_never_rebuild():
    env, engine = _mlp_engine(buckets=(2, 4))
    assert engine.warmup() == 2          # one program per bucket
    c0 = engine.compile_count
    obs = _obs_rows(env, 9)
    for n in (1, 2, 3, 4):
        for o in obs[:n]:
            engine.submit(o)
        engine.drain()
    assert engine.compile_count == c0
    _, p1 = engine.store.get()
    out1 = engine.eval_bucket(obs[:3], [0, 1, 2], 4)
    engine.store.publish(_scaled(p1, 1.5))
    out2 = engine.eval_bucket(obs[:3], [0, 1, 2], 4)
    assert engine.compile_count == c0
    assert any(not torch.equal(a, b) for a, b in zip(out1[1:], out2[1:]))


def test_responses_are_tagged_with_dispatch_version():
    env, engine = _mlp_engine(buckets=(4,))
    engine.warmup()
    obs = _obs_rows(env, 4)
    engine.submit(obs[0])
    (r1,) = engine.step()
    _, p = engine.store.get()
    v2 = engine.store.publish({k: v + 1e-3 for k, v in p.items()})
    engine.submit(obs[1])
    (r2,) = engine.step()
    assert r1["version"] == v2 - 1 and r2["version"] == v2


def test_one_host_to_device_copy_per_dispatch(monkeypatch):
    """A dispatch stages rows and noise in one host buffer and copies it
    to the device once."""
    env, engine = _mlp_engine(buckets=(4,))
    engine.warmup()
    host = engine._program(4).host
    calls = []
    real = torch.Tensor.copy_

    def spy(self, src, *args, **kw):
        calls.append(src.data_ptr() == host.data_ptr())
        return real(self, src, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "copy_", spy)
    for o in _obs_rows(env, 3):
        engine.submit(o)
    engine.step()
    assert calls == [True]


# ------------------------------------------------ parity with JAX serving
def _jax_and_port(env_name, kind):
    jspec, tspec = jenvs.make(env_name).spec, envs.make(env_name).spec
    if kind == "mlp":
        jp = JaxMLP.for_spec(jspec, hidden=(16,))
        tp = MLPPolicy.for_spec(tspec, hidden=(16,), device="cpu")
    else:
        small = dict(name="small-trunk", family="dense", n_layers=2,
                     d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64)
        jp = JaxTrunk.for_spec(jspec, arch=JaxConfig(
            **small, layer_pattern=(JAX_ATTN,)), reduced=False)
        tp = TrunkPolicy.for_spec(tspec, arch=ModelConfig(
            **small, layer_pattern=(ATTN,)), reduced=False, device="cpu")
    jparams = jp.init(jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jstore, tstore = JaxStore(), ParamStore()
    jstore.publish(jparams)
    tstore.publish(tparams)
    jeng = JaxEngine(jp, jspec.observation, buckets=(8,), store=jstore,
                     seed=4)
    teng = ServeEngine(tp, tspec.observation, buckets=(8,), store=tstore,
                       seed=4, device="cpu")
    return jp, jparams, jeng, tp, teng


@pytest.mark.parametrize("env_name,kind", [("cartpole", "mlp"),
                                           ("pendulum", "mlp"),
                                           ("cartpole", "trunk"),
                                           ("pendulum", "trunk")])
def test_engine_matches_jax_engine(env_name, kind):
    """Same params, same rows, fixed bucket: the port's value is JAX's;
    a categorical logp is JAX's log_softmax(pi)[a] at the port's action,
    a Gaussian logp the density of the port's own pre-tanh draw."""
    jp, jparams, jeng, tp, teng = _jax_and_port(env_name, kind)
    obs = _obs_rows(envs.make(env_name), 5, seed=3)
    _, _, v_j = jeng.eval_bucket([jnp.asarray(o) for o in obs],
                                 list(range(5)), 8)
    a_t, l_t, v_t = teng.eval_bucket(obs, list(range(5)), 8)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **TOL)
    pi, _ = jp.apply(jparams, jnp.asarray(np.stack(obs)))
    if tp.discrete:
        want = jnp.take_along_axis(jax.nn.log_softmax(pi),
                                   jnp.asarray(a_t.numpy())[:, None].astype(
                                       jnp.int32), -1)[:, 0]
    else:
        z = tp.request_noise(teng.seed, range(5))
        std = np.exp(np.asarray(jparams["log_std"]))
        want = (-0.5 * z ** 2 - np.log(std)
                - 0.5 * np.log(2 * np.pi)).sum(-1)
        assert bool(torch.all(a_t.abs() <= 2.0 + 1e-6))
    np.testing.assert_allclose(l_t.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------- CLI
def _run_cli(argv, out_dir):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_policy.main(argv + ["--out", str(out_dir)])
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_quick_on_cpu(tmp_path):
    out = _run_cli(["--device", "cpu", "--train-iters", "0", "--quick",
                    "--requests", "24"], tmp_path)
    assert out["loads"] == [500.0, 2000.0]
    assert out["bucket_configs"] == [[4, 16], [16]]
    assert out["warmup_compiles"] == 3
    assert out["recompiles_after_warmup"] == 0
    assert out["hot_swaps"] == 4 and len(out["cells"]) == 4
    assert out["source"] == "fresh-init" and out["device"] == "cpu"
    for cell in out["cells"]:
        assert cell["n"] == 24 and cell["versions"] >= 2
        assert cell["p99_ms"] >= cell["p50_ms"] > 0


@pytest.mark.parametrize("algo", ["ppo", "a3c", "impala"])
def test_cli_trains_in_process(algo, tmp_path):
    """--train-iters N > 0 trains the policy with the port's Trainer
    before serving it, as the reference does."""
    out = _run_cli(["--device", "cpu", "--algo", algo, "--train-iters",
                    "2", "--load", "4000", "--buckets", "4",
                    "--requests", "12"], tmp_path)
    assert out["source"] == "trained-in-process" and out["train_s"] >= 0
    assert out["recompiles_after_warmup"] == 0 and out["hot_swaps"] == 1


def test_cli_quick_trains_four_iterations(monkeypatch, tmp_path):
    import repro_torch.core.trainer as trainer_mod
    iters = []
    fit = trainer_mod.Trainer.fit
    monkeypatch.setattr(trainer_mod.Trainer, "fit",
                        lambda self, *a: iters.append(self.cfg.iters)
                        or fit(self, *a))
    out = _run_cli(["--device", "cpu", "--quick", "--load", "4000",
                    "--buckets", "4", "--requests", "8"], tmp_path)
    assert iters == [4] and out["source"] == "trained-in-process"


@pytest.mark.parametrize("flags,frag", [
    (["--train-iters", "-1"], "Trainer"),
    (["--load", "0"], "positive"), (["--load", "abc"], "load"),
    (["--buckets", "4,2"], "increasing"), (["--buckets", ";"], "empty"),
    (["--buckets", "x,y"], "integers"), (["--env", "nope"], "registered")])
def test_cli_rejects_bad_flags(flags, frag, capsys):
    with pytest.raises(SystemExit) as exc:
        serve_policy.main(["--device", "cpu"] + flags)
    assert exc.value.code == 2
    assert frag in capsys.readouterr().err


# ------------------------------------------- the card unless asked for
def test_default_device_refuses_to_run_on_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device is valid")
    spec = envs.make("cartpole").spec
    with pytest.raises(RuntimeError, match="CUDA"):
        MLPPolicy.for_spec(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrunkPolicy.for_spec(spec)
    policy = MLPPolicy.for_spec(spec, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(policy, spec.observation)
    with pytest.raises(RuntimeError, match="CUDA"):
        _run_cli(["--train-iters", "0", "--quick"], tmp_path)


# ------------------------------- ZeRO-3 checkpoint / serve round trip
@pytest.mark.parametrize("kind", ["mlp", "trunk"])
def test_zero3_checkpoint_serve_round_trip_bitwise(kind, tmp_path):
    """Fit under zero3(2, 2), save the plan-independent state, then serve
    it three ways: live through the wrapper's `publish_from_state`,
    restored into a plain agent, and restored through ZeRO-3 wrappers at
    2 and 4 shards (the archive dealt into each one's host layout and
    reassembled by `host_state`). Every way serves the same actions,
    log-probs and values, bitwise; the MLP archive also restores into the
    reference's ParamStore, leaf for leaf."""
    from repro_torch.checkpoint import load_train_state, save_train_state
    from repro_torch.core import agent as agent_api
    from repro_torch.core.distribution import DistPlan
    from repro_torch.core.topology import ZeRO3Agent
    from repro_torch.core.trainer import Trainer, TrainerConfig
    env = envs.make("cartpole")
    kw = ({"hidden": (16,)} if kind == "mlp" else
          {"policy": "trunk", "trunk_kwargs": {"reduced": True}})
    cfg = TrainerConfig(algo="impala", iters=2, superstep=2, n_envs=8,
                        unroll=6, plan=DistPlan.zero3(2, 2), seed=0,
                        algo_kwargs=kw)
    trainer = Trainer(env, cfg, device="cpu")
    state, _ = trainer.fit()
    assert trainer.partition["listwise"] is (kind == "trunk")
    path = save_train_state(str(tmp_path / f"zero3_{kind}.npz"), state)
    make = lambda: agent_api.make("impala", env=env, ring_size=1,
                                  total_iters=2, device="cpu", **kw)
    stores = []
    live = ParamStore()
    live.publish_from_state(trainer.agent, state)
    stores.append(live)
    restored = ParamStore()
    restored.load_checkpoint(path, make())
    stores.append(restored)
    for n in (2, 4):
        wrapped = ZeRO3Agent(make(), "shard", n)
        host = wrapped.shard_state(load_train_state(path, "cpu"))
        assert host.params["zero3"][0].shape[0] == n
        store = ParamStore()
        store.publish_from_state(wrapped, host)
        stores.append(store)
    obs = _obs_rows(env, 5)
    outs = []
    for store in stores:
        engine = ServeEngine(trainer.agent.policy, env.spec.observation,
                             buckets=(8,), store=store, seed=11,
                             device="cpu")
        outs.append(engine.eval_bucket(obs, list(range(5)), 8))
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            assert torch.equal(a, b)
    if kind == "mlp":
        from repro.core import agent as jax_agents
        jagent = jax_agents.make("impala", env=jenvs.make("cartpole"),
                                 ring_size=1, total_iters=2, hidden=(16,))
        jstore = JaxStore()
        jstore.load_checkpoint(path, jagent)
        want = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      jstore.get()[1]))
        got = live.get()[1]
        assert sorted(want) == sorted(got)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
