"""Weights carried between the JAX package and the port: the convert
round trip, npz archives written by either package restoring into the
other, and a JAX Trainer archive served by the port through
`ParamStore.load_checkpoint(path, agent)`: the same published tree as
JAX's `ParamStore.load_checkpoint` (for dqn with its exploration rate
`eps`), with the JAX policy's outputs.

Round trips are bitwise; policy outputs are held to f32 atol = rtol =
2e-5 (the same math summed in another order)."""
import io
import json
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as jenvs
import repro_torch.envs as tenvs
from repro.checkpoint.ckpt import load_checkpoint as jax_load
from repro.checkpoint.ckpt import save_checkpoint as jax_save
from repro.configs.base import ATTN as JAX_ATTN
from repro.configs.base import ModelConfig as JaxConfig
from repro.core import agent as jax_agents
from repro.core.networks import TrunkPolicy as JaxTrunk
from repro.core.serving import ParamStore as JaxParamStore
from repro_torch.checkpoint import (load_actor_policy, load_checkpoint,
                                    params_from_jax, params_to_jax,
                                    save_checkpoint)
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.core import agent as tagents
from repro_torch.core.networks import MLPPolicy, TrunkPolicy
from repro_torch.core.serving import ParamStore
from repro_torch.launch import serve_policy

TOL = dict(atol=2e-5, rtol=2e-5)
SMALL = dict(name="small-trunk", family="dense", n_layers=3, d_model=32,
             n_heads=4, n_kv_heads=2, d_ff=64, vocab=64)


def _jax_trunk_params(spec_name="pendulum"):
    spec = jenvs.make(spec_name).spec
    pol = JaxTrunk.for_spec(spec, arch=JaxConfig(
        **SMALL, layer_pattern=(JAX_ATTN,)), reduced=False)
    return pol, pol.init(jax.random.PRNGKey(0))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert ta == tb
    for (pa, xa), (pb, xb) in zip(la, lb):
        assert pa == pb
        assert np.asarray(xa).dtype == np.asarray(xb).dtype, pa
        np.testing.assert_array_equal(np.asarray(xa), np.asarray(xb))


def test_convert_round_trip_is_bitwise():
    _, jparams = _jax_trunk_params()
    tree = _np_tree(jparams)
    flat = params_from_jax(tree)
    # stacked super-blocks split per block: (repeats,) leading dim gone
    assert flat["lm/stack/2/t0/mixer/wq"].shape == (32, 4, 8)
    np.testing.assert_array_equal(flat["lm/stack/1/t0/ffn/wi"].numpy(),
                                  tree["lm"]["stack"]["t0"]["ffn"]["wi"][1])
    # params a mode does not use ride along (feature mode: the embedding)
    assert "lm/embed/tok" in flat and "lm/embed/unembed" in flat
    _assert_trees_equal(params_to_jax(flat), tree)
    back = params_from_jax(params_to_jax(flat))
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert torch.equal(back[k], flat[k]), k


def test_jax_archive_loads_into_port(tmp_path):
    _, jparams = _jax_trunk_params()
    path = jax_save(str(tmp_path / "jax.npz"), jparams, step=7)
    template = TrunkPolicy.for_spec(
        tenvs.make("pendulum").spec, arch=ModelConfig(
            **SMALL, layer_pattern=(ATTN,)), reduced=False,
        device="cpu").init(torch.Generator())
    got, step = load_checkpoint(path, template)
    assert step == 7
    want = params_from_jax(_np_tree(jparams))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_port_archive_loads_into_jax(tmp_path):
    pol, jparams = _jax_trunk_params()
    params = params_from_jax(_np_tree(jparams))
    path = save_checkpoint(str(tmp_path / "port.npz"), params, step=3)
    example = pol.init(jax.random.PRNGKey(1))
    tree, step = jax_load(path, example)
    assert step == 3
    _assert_trees_equal(tree, jparams)


def _trainer_archive(tmp_path, algo, fit):
    """A JAX Trainer TrainState archive: fitted for two iterations with a
    two-slot actor ring, or (cheaper) freshly initialised. Returns the
    JAX agent, its state, the path and the agent's construction kwargs."""
    env = jenvs.make("cartpole")
    if fit:
        from repro.core.trainer import Trainer, TrainerConfig
        cfg = TrainerConfig(algo=algo, iters=2, superstep=1, n_envs=4,
                            unroll=4, policy_lag=1, seed=0, log_every=1)
        trainer = Trainer(env, cfg)
        state, _ = trainer.fit()
        agent = trainer.agent
        kwargs = dict(ring_size=agent.ring_size, total_iters=cfg.iters)
    else:
        kwargs = dict(ring_size=1, total_iters=1)
        agent = jax_agents.make(algo, env, **kwargs)
        state = agent.init(jax.random.PRNGKey(0))
    path = jax_save(str(tmp_path / f"{algo}.npz"), state)
    return agent, state, path, kwargs


def _serve_outputs(path, algo, agent, state, delay, kwargs):
    """The port's `ParamStore.load_checkpoint(path, agent, delay=delay)`
    against JAX's on the same archive: the published trees (flat, as the
    port keys them) and the policy's outputs on them."""
    tagent = tagents.make(algo, env=tenvs.make("cartpole"), device="cpu",
                          **kwargs)
    store = ParamStore()
    assert store.load_checkpoint(path, tagent, delay=delay) == 1
    _, params = store.get()
    jstore = JaxParamStore()
    jstore.load_checkpoint(path, agent, delay=delay)
    want_params = params_from_jax(_np_tree(jstore.get()[1]))
    assert sorted(params) == sorted(want_params)
    for k, w in want_params.items():
        np.testing.assert_allclose(params[k].numpy(), w.numpy(), **TOL)
    obs = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    got = tagent.policy.apply(params, torch.tensor(obs))
    want = agent.policy.apply(agent.actor_policy(state, delay),
                              jnp.asarray(obs))
    return got, want, params


@pytest.mark.parametrize("algo", ["a3c", "impala", "ppo", "dqn"])
def test_trainer_archive_serves_jax_policy(algo, tmp_path):
    agent, state, path, kwargs = _trainer_archive(tmp_path, algo, fit=False)
    got, want, params = _serve_outputs(path, algo, agent, state, 0, kwargs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if algo == "dqn":  # the exploration rate rides with the net
        assert float(params["eps"]) == float(agent.actor_policy(
            state, 0)["eps"])


def test_fitted_trainer_archive_serves_each_ring_slot(tmp_path):
    """After two PPO updates with a two-slot ring, slot `delay` of the
    archive is what `agent.actor_policy(state, delay)` serves."""
    agent, state, path, kwargs = _trainer_archive(tmp_path, "ppo", fit=True)
    outs = []
    for delay in (0, 1):
        got, want, _ = _serve_outputs(path, "ppo", agent, state, delay,
                                      kwargs)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        outs.append(got[0])
    assert not torch.equal(outs[0], outs[1])  # the slots differ


def test_cli_serves_a_trainer_archive(tmp_path):
    _, _, path, _ = _trainer_archive(tmp_path, "impala", fit=False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_policy.main(["--device", "cpu", "--algo", "impala",
                           "--ckpt", path, "--train-iters", "5",
                           "--load", "4000", "--buckets", "4",
                           "--requests", "12"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["source"] == "checkpoint" and out["device"] == "cpu"
    assert out["recompiles_after_warmup"] == 0 and out["hot_swaps"] == 1


def test_archive_without_ring_is_refused(tmp_path):
    _, jparams = _jax_trunk_params()
    path = jax_save(str(tmp_path / "plain.npz"), jparams)
    with pytest.raises(KeyError, match="ring"):
        load_actor_policy(path, {})


def _jax_moe_lm():
    """deepseek-moe-16b reduced, at 4 layers: a prefix list of one dense
    block, then three stacked MoE super-blocks."""
    import dataclasses
    from repro.configs.base import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    cfg = dataclasses.replace(
        jax_get_config("deepseek-moe-16b").reduced(), n_layers=4)
    return jax_build_model(cfg).init(jax.random.PRNGKey(0))


def test_moe_lm_round_trip_keeps_the_prefix_list():
    tree = _np_tree(_jax_moe_lm())
    assert isinstance(tree["prefix"], list) and len(tree["prefix"]) == 1
    flat = params_from_jax(tree)
    assert flat["prefix/0/ffn/wi"].shape == (128, 128)      # dense layer 0
    assert flat["stack/2/t0/ffn/wi"].shape == (4, 128, 64)  # (E, d, f)
    assert flat["stack/0/t0/ffn/shared/wo"].shape == (64, 128)
    assert flat["stack/1/t0/ffn/router"].shape == (128, 4)
    np.testing.assert_array_equal(flat["stack/1/t0/ffn/wo"].numpy(),
                                  tree["stack"]["t0"]["ffn"]["wo"][1])
    _assert_trees_equal(params_to_jax(flat), tree)
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import ModelOpts, build_model
    tm = build_model(dataclasses.replace(
        get_config("deepseek-moe-16b").reduced(), n_layers=4),
        ModelOpts(dtype="float32"))
    template = tm.init(torch.Generator(), "cpu")
    assert sorted(template) == sorted(flat)
    assert all(template[k].shape == flat[k].shape for k in flat)


def test_moe_lm_port_archive_loads_into_jax(tmp_path):
    jparams = _jax_moe_lm()
    path = save_checkpoint(str(tmp_path / "moe.npz"),
                           params_from_jax(_np_tree(jparams)))
    tree, _ = jax_load(path, jparams)
    _assert_trees_equal(tree, jparams)


def test_lm_init_defaults_to_the_card():
    """The LM entry point draws on the card unless told otherwise, and
    raises without one instead of running on the CPU."""
    from repro_torch.checkpoint import load_train_state
    from repro_torch.models.model import ModelOpts, build_model
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    tm = build_model("smollm-360m", ModelOpts(dtype="float32"), reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init(torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_train_state("unused.npz")


def test_lm_init_stores_matrices_in_the_model_dtype():
    """bf16 models store every matrix in bf16 and the norm scales in f32
    (JAX stores f32 and casts each matrix to bf16 at use, and uses the
    norm scales in f32): the same values, one cast made once."""
    from repro_torch.models.model import ModelOpts, build_model
    tm = build_model("deepseek-moe-16b", ModelOpts(dtype="bfloat16"),
                     reduced=True)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    f32 = sorted(k for k, v in params.items() if v.dtype == torch.float32)
    assert f32 == ["final_norm/scale", "prefix/0/norm1/scale",
                   "prefix/0/norm2/scale", "stack/0/t0/norm1/scale",
                   "stack/0/t0/norm2/scale"]
    assert all(v.dtype == torch.bfloat16 for k, v in params.items()
               if k not in f32)
    ref = build_model("deepseek-moe-16b", ModelOpts(dtype="float32"),
                      reduced=True).init(torch.Generator().manual_seed(0),
                                         "cpu")
    for k in params:
        assert torch.equal(params[k], ref[k].to(params[k].dtype)), k


# sha256 over (key, bytes) in key order of the policies' params for
# torch.Generator().manual_seed(0), as the port drew them before its LM
# init moved to the generator's device
POLICY_FINGERPRINTS = {
    ("cartpole", "trunk"):
        "e4980b30f355e7dec7ea93a846e5d74ea692f61b4ffd69e2f63b4fcb4bd86835",
    ("cartpole", "mlp"):
        "7360ed5f6dfd6c09d79091a5f728e1be534bbba145f628010cbfc77d7e2d248d",
    ("pendulum", "trunk"):
        "a9dc24786b0a49b8bf0935f80556a3a36fe1225294b902c922f1ba41540db08e",
    ("pendulum", "mlp"):
        "ecf665cf48e4e1a7efb7290481699be24c23ea094120279d427d81b4b4c30d6f",
}


@pytest.mark.parametrize("env_name,policy", sorted(POLICY_FINGERPRINTS))
def test_cpu_generator_policy_weights_are_unchanged(env_name, policy):
    import hashlib
    spec = tenvs.make(env_name).spec
    pol = (TrunkPolicy.for_spec(spec, reduced=False, device="cpu")
           if policy == "trunk" else MLPPolicy.for_spec(spec, device="cpu"))
    params = pol.init(torch.Generator().manual_seed(0))
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].contiguous().numpy().tobytes())
    assert h.hexdigest() == POLICY_FINGERPRINTS[(env_name, policy)]
