"""The port's policy trunk against the JAX package on the CPU: layers
(norms, half-split RoPE, SwiGLU), LanguageModel._run_seq, TrunkPolicy in
feature and token mode with use_kernels on and off, and MLPPolicy, all
on params carried across by checkpoint.convert.params_from_jax.

Tolerance: f32 atol = rtol = 2e-5 (tests/test_trunk.py), the same math
summed in another order; sampled discrete actions are exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as jenvs
import repro_torch.envs as tenvs
from repro.configs.base import get_config as jax_get_config
from repro.core.networks import MLPPolicy as JaxMLP
from repro.core.networks import TrunkPolicy as JaxTrunk
from repro.models import layers as jl
from repro.models.model import LanguageModel as JaxLM
from repro.models.model import ModelOpts as JaxOpts
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.configs.base import ATTN, ModelConfig, get_config
from repro_torch.core.networks import MLPPolicy, TrunkPolicy, make_policy
from repro_torch.kernels.flash_attention.kernel import flash_attention_hsd
from repro_torch.models import layers as tl
from repro_torch.models.model import LanguageModel, ModelOpts

TOL = dict(atol=2e-5, rtol=2e-5)
SMALL = dict(name="small-trunk", family="dense", n_layers=2, d_model=32,
             n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
             layer_pattern=(ATTN,))


def _jax_cfg():
    from repro.configs.base import ModelConfig as JaxConfig
    return JaxConfig(**SMALL)


def _np(a):
    return np.asarray(a)


def _from_jax(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy(), _np(want), **TOL)


# ---------------------------------------------------------------- configs
def test_paper_drl_trunk_config_matches_jax():
    fields = [f.name for f in dataclasses.fields(ModelConfig)]
    for reduced in (False, True):
        ours = get_config("paper-drl-trunk")
        theirs = jax_get_config("paper-drl-trunk")
        if reduced:
            ours, theirs = ours.reduced(), theirs.reduced()
        for f in fields:
            assert getattr(ours, f) == getattr(theirs, f), (reduced, f)
    full = get_config("paper-drl-trunk")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab) == (4, 256, 4, 2, 64, 512,
                                                      1024)


def test_unknown_arch_names_the_roadmap_item():
    """An unknown name raises, listing the architectures the port has
    (the whole LM zoo now: gemma3-1b among them resolves)."""
    with pytest.raises(KeyError, match="gemma3-1b"):
        get_config("gemma3-2b")
    assert get_config("gemma3-1b").name == "gemma3-1b"


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(norm):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3
    params = {"scale": rng.standard_normal(16).astype(np.float32)}
    if norm == "layernorm":
        params["bias"] = rng.standard_normal(16).astype(np.float32)
    want = jl.apply_norm({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x))
    got = tl.apply_norm({k: torch.tensor(v) for k, v in params.items()},
                        torch.tensor(x))
    _close(got, want)


@pytest.mark.parametrize("pos0", [0, 7])
def test_rope_half_split_matches_jax(pos0):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.arange(6) + pos0
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tl.apply_rope(torch.tensor(x), torch.tensor(pos), 10000.0)
    _close(got, want)
    # the half-split form, not the interleaved one: dim i pairs with i+D/2
    d = x.shape[-1] // 2
    ang = pos[:, None] * (1.0 / 10000.0 ** (np.arange(0, 2 * d, 2) / (2 * d)))
    first = (x[..., :d] * np.cos(ang)[None, :, None]
             - x[..., d:] * np.sin(ang)[None, :, None])
    np.testing.assert_allclose(got[..., :d].numpy(), first, atol=1e-5)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.2
              for k, s in (("wi", (16, 24)), ("wg", (16, 24)),
                           ("wo", (24, 16)))}
    want = jl.apply_mlp({k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(x))
    got = tl.apply_mlp({k: torch.tensor(v) for k, v in params.items()},
                       torch.tensor(x))
    _close(got, want)


def test_embed_and_unembed_match_jax():
    cfg = ModelConfig(**SMALL)
    jparams = jl.init_embed(_jax_cfg(), jax.random.PRNGKey(0))
    tparams = {k: torch.tensor(np.asarray(v)) for k, v in jparams.items()}
    tok = np.random.default_rng(3).integers(0, 64, (2, 5))
    want = jl.embed_tokens(jparams, jnp.asarray(tok), _jax_cfg(),
                           jnp.float32)
    got = tl.embed_tokens(tparams, torch.tensor(tok), cfg, torch.float32)
    _close(got, want)
    _close(tl.unembed(tparams, got, cfg),
           jl.unembed(jparams, want, _jax_cfg()))


def test_dense_init_is_seeded_truncated_fan_in():
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    a, b = tl.dense_init(g1, (64, 32)), tl.dense_init(g2, (64, 32))
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert float(a.abs().max()) <= 2.0 * 64 ** -0.5 + 1e-7


# ---------------------------------------------------------- LanguageModel
@pytest.mark.parametrize("use_kernels", [True, False])
def test_run_seq_matches_jax(use_kernels):
    """Two blocks, 4 query heads over 2 kv heads (G = 2)."""
    jlm = JaxLM(_jax_cfg(), JaxOpts(dtype="float32", remat=False,
                                    use_kernels=use_kernels))
    tlm = LanguageModel(ModelConfig(**SMALL),
                        ModelOpts(dtype="float32", use_kernels=use_kernels))
    jparams = jlm.init(jax.random.PRNGKey(0))
    tparams = _from_jax(jparams)
    assert sorted(tparams) == sorted(tlm.init(torch.Generator(), "cpu"))
    x = np.random.default_rng(4).standard_normal((3, 7, 32)) \
        .astype(np.float32)
    want, _, _ = jlm._run_seq(jparams, jnp.asarray(x), jnp.int32(0), None, 0)
    got, _, _ = tlm._run_seq(tparams, torch.tensor(x))
    _close(got, want)


# ------------------------------------------------------------ TrunkPolicy
def _trunk_pair(env_name, use_kernels, **kw):
    jspec, tspec = jenvs.make(env_name).spec, tenvs.make(env_name).spec
    if kw.get("ctx"):
        jp = JaxTrunk(_jax_cfg(), reduced=False, use_kernels=use_kernels,
                      **kw)
        tp = TrunkPolicy(ModelConfig(**SMALL), reduced=False,
                         use_kernels=use_kernels, device="cpu", **kw)
    else:
        jp = JaxTrunk.for_spec(jspec, arch=_jax_cfg(), reduced=False,
                               use_kernels=use_kernels)
        tp = TrunkPolicy.for_spec(tspec, arch=ModelConfig(**SMALL),
                                  reduced=False, use_kernels=use_kernels,
                                  device="cpu")
    jparams = jp.init(jax.random.PRNGKey(0))
    tparams = _from_jax(jparams)
    template = tp.init(torch.Generator().manual_seed(0))
    assert sorted(template) == sorted(tparams)
    assert all(template[k].shape == tparams[k].shape for k in template)
    return jp, tp, jparams, tparams


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("env_name", ["cartpole", "pendulum"])
def test_trunk_feature_mode_matches_jax(env_name, use_kernels):
    jp, tp, jparams, tparams = _trunk_pair(env_name, use_kernels)
    flash_attention_hsd.launches = 0
    obs = np.random.default_rng(5).standard_normal(
        (6, tp.features)).astype(np.float32)
    lj, vj = jp.apply(jparams, jnp.asarray(obs))
    lt, vt = tp.apply(tparams, torch.tensor(obs))
    assert lt.shape == lj.shape and vt.shape == vj.shape
    _close(lt, lj)
    _close(vt, vj)
    assert flash_attention_hsd.launches == 0  # CPU tensors: plain version


@pytest.mark.parametrize("use_kernels", [True, False])
def test_trunk_token_mode_matches_jax(use_kernels):
    jp, tp, jparams, tparams = _trunk_pair("gridworld", use_kernels,
                                           n_actions=4, ctx=5)
    assert tp.features is None and "feat/w" not in tparams
    obs = np.random.default_rng(6).integers(0, 500, (4, 5)).astype(np.int32)
    lj, vj = jp.apply(jparams, jnp.asarray(obs))
    lt, vt = tp.apply(tparams, torch.tensor(obs))
    _close(lt, lj)
    _close(vt, vj)


@pytest.mark.parametrize("env_name", ["cartpole", "pendulum"])
def test_trunk_sample_and_log_prob_match_jax(env_name):
    """Fed JAX's own noise (the Gumbel draw `categorical` makes, the
    normal draw of the Gaussian head), the port samples JAX's action and
    log-prob; log_prob of that action agrees too."""
    jp, tp, jparams, tparams = _trunk_pair(env_name, True)
    obs = np.random.default_rng(7).standard_normal(
        (5, tp.features)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    a_j, lp_j = jp.sample(jparams, jnp.asarray(obs), key)
    shape = (5, tp.noise_dim)
    noise = (jax.random.gumbel(key, shape) if tp.discrete
             else jax.random.normal(key, shape))
    a_t, lp_t = tp.sample(tparams, torch.tensor(obs),
                          torch.tensor(np.asarray(noise)))
    if tp.discrete:
        np.testing.assert_array_equal(a_t.numpy(), _np(a_j))
    else:
        _close(a_t, a_j)
    _close(lp_t, lp_j)
    lpj, vj, entj = jp.log_prob(jparams, jnp.asarray(obs), a_j)
    lpt, vt, entt = tp.log_prob(tparams, torch.tensor(obs),
                                torch.tensor(np.asarray(a_j)))
    for got, want in ((lpt, lpj), (vt, vj), (entt, entj)):
        _close(got, want)


def test_trunk_full_width_for_spec():
    """`for_spec` keeps JAX's default reduced=True; reduced=False is the
    full-width paper-drl-trunk."""
    spec = tenvs.make("cartpole").spec
    small = TrunkPolicy.for_spec(spec, device="cpu")
    full = TrunkPolicy.for_spec(spec, reduced=False, device="cpu")
    assert small.lm.cfg.d_model == 128 and full.lm.cfg.d_model == 256
    assert full.lm.cfg.n_layers == 4 and full.lm.repeats == 4
    assert full.lm.attn_opts.use_kernels


# -------------------------------------------------------------- MLPPolicy
@pytest.mark.parametrize("env_name", ["cartpole", "pendulum", "gridworld"])
def test_mlp_matches_jax(env_name):
    jspec, tspec = jenvs.make(env_name).spec, tenvs.make(env_name).spec
    jp = JaxMLP.for_spec(jspec, hidden=(16, 8))
    tp = make_policy(tspec, "mlp", hidden=(16, 8), device="cpu")
    assert isinstance(tp, MLPPolicy)
    jparams = jp.init(jax.random.PRNGKey(1))
    tparams = _from_jax(jparams)
    assert sorted(tparams) == sorted(tp.init(torch.Generator()))
    obs = np.random.default_rng(8).standard_normal(
        (7, tspec.obs_dim)).astype(np.float32)
    lj, vj = jp.apply(jparams, jnp.asarray(obs))
    lt, vt = tp.apply(tparams, torch.tensor(obs))
    _close(lt, lj)
    _close(vt, vj)


def test_make_policy_rejects_unknown_kind():
    spec = tenvs.make("cartpole").spec
    with pytest.raises(ValueError, match="policy"):
        make_policy(spec, "resnet", device="cpu")
