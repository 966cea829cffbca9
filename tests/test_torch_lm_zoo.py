"""The LM zoo's modules in the port against the JAX package on the CPU,
on inputs made from a seed with numpy and weights carried across by
checkpoint.convert (`params_from_jax`, then `unflatten_tree` where a
function takes a nested param dict):

  * local (sliding-window) attention at tests/test_models.py's (S, w)
    cases, the whisper encoder's non-causal pass, cross attention
    (sequence and decode), MLA (sequence, the absorbed decode, and the
    absorbed decode against the expanded sequence path), the GELU MLP;
  * Mamba: the chunked scan against a per-step scan and against JAX's,
    `mamba_seq` (prefill from a nonzero state) and `mamba_decode`, and
    in bf16 against the reference's compiled bf16 graph;
  * row-local MoE dispatch against the reference and the dense oracle;
  * gemma3-1b reduced (window 64) at a 128-token prompt: the local
    layers' ring caches keep the last 64 positions, and decode wraps them;
  * the configs: every field of every arch, full and reduced,
    `param_count` (all and active), `subquadratic`, `list_archs` and the
    four `SHAPES`;
  * checkpoints: params_from_jax -> params_to_jax is the identity for
    whisper (`enc/stack`, `enc/pos`) and paligemma (`projector`), and a
    reduced whisper survives save_checkpoint / load_checkpoint bitwise.

Tolerance: f32 rtol = 2e-5, atol = 1e-5 x max|reference| (the same math
summed in another order, tests/test_torch_lm_serve.py's); the Mamba
scans against a per-step scan rtol 1e-3, atol 2e-4 (tests/test_models.py's);
the bf16 Mamba mixer within one bf16 rounding (2^-8) x max|reference|
of the reference's bf16 output; integer outputs, param counts and
configs exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import build_model as jax_build_model
from repro.models.model import ModelOpts as JaxOpts
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.checkpoint.convert import (flatten_tree, params_from_jax,
                                            params_to_jax, unflatten_tree)
from repro_torch.launch.serve import stub_frontend
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models.model import ModelOpts, build_model

JOPTS = jattn.AttnOpts(dtype=jnp.float32)
TOPTS = tattn.AttnOpts(dtype=torch.float32)


def _close(got, want, rtol=2e-5, atol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=rtol, atol=atol * float(np.abs(want).max()))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cfgs(arch):
    return (jconfigs.get_config(arch).reduced(),
            tconfigs.get_config(arch).reduced())


def _tree(jtree):
    """A JAX param tree -> the same nested dicts of CPU tensors."""
    return unflatten_tree(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtree)))


def _cache(jcache):
    return {k: torch.tensor(np.asarray(v)) for k, v in jcache.items()}


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("S,w", [(64, 16), (128, 32), (96, 32)])
def test_local_attention_matches_jax(S, w):
    B, KVH, G, D = 1, 1, 4, 16
    q, k, v = (_x(s, seed) for seed, s in enumerate(
        [(B, S, KVH, G, D), (B, S, KVH, D), (B, S, KVH, D)]))
    want = jattn.local_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.int32(0), window=w)
    got = tattn.local_attention(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), 0, window=w)
    _close(got, want)


def _attn_params(jcfg, kind, seed=0):
    jp = jattn.init_attn(jcfg, jax.random.PRNGKey(seed), kind)
    return jp, _tree(jp)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_encoder_pass_is_non_causal_and_matches_jax(use_kernels):
    """The whisper encoder's self-attention: RoPE, no mask, whatever
    `use_kernels` (the reference sends only causal ATTN to the kernel)."""
    jcfg, tcfg = _cfgs("whisper-base")
    jp, tp = _attn_params(jcfg, "attn")
    x = _x((2, tcfg.enc_tokens, tcfg.d_model), 1)
    want, _ = jattn.gqa_seq(jcfg, jp, jnp.asarray(x), jnp.int32(0), "attn",
                            dataclasses.replace(JOPTS,
                                                use_kernels=use_kernels),
                            causal=False)
    got, cache = tattn.gqa_seq(tcfg, tp, torch.tensor(x), 0, "attn",
                               dataclasses.replace(TOPTS,
                                                   use_kernels=use_kernels),
                               causal=False)
    assert cache is None
    _close(got, want)
    # the last query sees the whole sequence: not the causal result
    causal, _ = tattn.gqa_seq(tcfg, tp, torch.tensor(x), 0, "attn", TOPTS)
    assert (causal - got)[:, 0].abs().max() > 1e-3


def test_cross_attention_seq_and_decode_match_jax():
    """Decoder queries against (B, Te, KVH, D) encoder keys and values:
    the sequence path (f32 blockwise) and the decode path (scores in the
    model's dtype, softmax in f32), neither with RoPE."""
    jcfg, tcfg = _cfgs("whisper-base")
    jp, tp = _attn_params(jcfg, "attn", seed=3)
    B, S, Te = 2, 5, tcfg.enc_tokens
    x = _x((B, S, tcfg.d_model), 4)
    ek = _x((B, Te, tcfg.n_kv_heads, tcfg.head_dim), 5)
    ev = _x((B, Te, tcfg.n_kv_heads, tcfg.head_dim), 6)
    jkv, tkv = (jnp.asarray(ek), jnp.asarray(ev)), (torch.tensor(ek),
                                                  torch.tensor(ev))
    want, _ = jattn.gqa_seq(jcfg, jp, jnp.asarray(x), jnp.int32(3), "attn",
                            JOPTS, cross_kv=jkv)
    got, cache = tattn.gqa_seq(tcfg, tp, torch.tensor(x), 3, "attn", TOPTS,
                               cross_kv=tkv)
    assert cache is None
    _close(got, want)
    want, _ = jattn.gqa_decode(jcfg, jp, jnp.asarray(x[:, :1]), None,
                               jnp.int32(7), "attn", JOPTS, cross_kv=jkv)
    got = tattn.gqa_decode(tcfg, tp, torch.tensor(x[:, :1]), None, 7, "attn",
                           TOPTS, cross_kv=tkv)
    _close(got, want)
    # position-free: the first sequence row is the decode step's output
    _close(got, tattn.gqa_seq(tcfg, tp, torch.tensor(x), 3, "attn", TOPTS,
                              cross_kv=tkv)[0][:, :1].numpy())


def test_mla_seq_and_absorbed_decode_match_jax():
    jcfg, tcfg = _cfgs("minicpm3-4b")
    jp, tp = _attn_params(jcfg, "mla", seed=7)
    B, S, cap = 2, 9, 12
    x = _x((B, S, tcfg.d_model), 8)
    want, jcache = jattn.mla_seq(jcfg, jp, jnp.asarray(x), jnp.int32(0),
                                 JOPTS, cache_capacity=cap)
    got, cache = tattn.mla_seq(tcfg, tp, torch.tensor(x), 0, TOPTS,
                               cache_capacity=cap)
    _close(got, want)
    assert cache["ckv"].shape == (B, cap, tcfg.kv_lora_rank)
    assert cache["kr"].shape == (B, cap, tcfg.rope_head_dim)
    for key in ("ckv", "kr"):
        _close(cache[key], jcache[key])
    xt = _x((B, 1, tcfg.d_model), 9)
    want, jcache = jattn.mla_decode(jcfg, jp, jnp.asarray(xt), jcache,
                                    jnp.int32(S), JOPTS)
    got = tattn.mla_decode(tcfg, tp, torch.tensor(xt), cache, S, TOPTS)
    _close(got, want)
    for key in ("ckv", "kr"):  # written in place, slot S
        _close(cache[key], jcache[key])


def test_mla_absorbed_decode_equals_the_expanded_sequence_path():
    """Over a cache holding exactly the S tokens (no zero slot), the
    absorbed decode of token S-1 is the causal sequence path's last
    row."""
    _, tcfg = _cfgs("minicpm3-4b")
    _, tp = _attn_params(_cfgs("minicpm3-4b")[0], "mla", seed=10)
    S = 7
    x = torch.tensor(_x((2, S, tcfg.d_model), 11))
    seq, _ = tattn.mla_seq(tcfg, tp, x, 0, TOPTS)
    _, cache = tattn.mla_seq(tcfg, tp, x[:, :S - 1], 0, TOPTS,
                             cache_capacity=S)
    got = tattn.mla_decode(tcfg, tp, x[:, S - 1:], cache, S - 1, TOPTS)
    _close(got, seq[:, S - 1:].numpy())


def test_gelu_mlp_matches_jax():
    jcfg, tcfg = _cfgs("whisper-base")
    jp = jlayers.init_mlp_gelu(jcfg, jax.random.PRNGKey(12))
    x = _x((2, 5, tcfg.d_model), 13)
    _close(tlayers.apply_mlp_gelu(_tree(jp), torch.tensor(x)),
           jlayers.apply_mlp_gelu(jp, jnp.asarray(x)))


# ----------------------------------------------------------------- mamba
def _scan_inputs(B, T, di, N, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, T, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, di)))).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal((di, N))).astype(np.float32)
    h0 = 0.5 * rng.standard_normal((B, di, N)).astype(np.float32)
    return u, dt, Bm, Cm, A, h0


@pytest.mark.parametrize("T,chunk", [(40, 8), (40, 32), (5, 32), (1, 1)])
def test_ssm_scan_matches_step_scan_and_jax(T, chunk):
    args = _scan_inputs(2, T, 8, 4, seed=T + chunk)
    y, s = tmamba.ssm_scan_chunked(*map(torch.tensor, args), chunk=chunk)
    u, dt, Bm, Cm, A, h = (a.astype(np.float64) for a in args)
    ys = []
    for t in range(T):  # the per-step recurrence, in float64
        h = np.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * u[:, t])[:, :, None] * Bm[:, t, None, :]
        ys.append(np.einsum("bdn,bn->bd", h, Cm[:, t]))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(s.numpy(), h, atol=2e-4, rtol=1e-3)
    jy, js = jmamba.ssm_scan_chunked(*map(jnp.asarray, args), chunk=chunk)
    _close(y, jy)
    _close(s, js)


def _mamba_pair(seed=14):
    jcfg, tcfg = _cfgs("jamba-v0.1-52b")
    jp = jmamba.init_mamba(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, _tree(jp)


def _mamba_state(cfg, seed, dtype=np.float32):
    di = cfg.ssm_expand * cfg.d_model
    return {"conv": _x((2, cfg.ssm_conv - 1, di), seed).astype(dtype),
            "ssm": 0.1 * _x((2, di, cfg.ssm_state), seed + 1)}


@pytest.mark.parametrize("T", [6, 40])
def test_mamba_seq_and_decode_match_jax(T):
    """A prefill of T tokens from a nonzero state, then three decode
    steps (chunk 1) from the state it leaves."""
    jcfg, tcfg, jp, tp = _mamba_pair()
    x = _x((2, T, tcfg.d_model), 15)
    st = _mamba_state(tcfg, 16)
    want, jst = jmamba.mamba_seq(jcfg, jp, jnp.asarray(x),
                                 jax.tree_util.tree_map(jnp.asarray, st))
    got, tst = tmamba.mamba_seq(tcfg, tp, torch.tensor(x), _cache(st))
    _close(got, want)
    assert tst["conv"].shape == st["conv"].shape
    for key in ("conv", "ssm"):
        _close(tst[key], jst[key])
    for i in range(3):
        xt = _x((2, 1, tcfg.d_model), 17 + i)
        want, jst = jmamba.mamba_decode(jcfg, jp, jnp.asarray(xt), jst)
        got, tst = tmamba.mamba_decode(tcfg, tp, torch.tensor(xt), tst)
        _close(got, want)
        for key in ("conv", "ssm"):
            _close(tst[key], jst[key])


@pytest.mark.parametrize("T", [1, 6, 40])
def test_mamba_bf16_follows_the_references_compiled_graph(T):
    """In bf16 the reference's compiled graph rounds each step of
    silu(u) for the two projections but hands the scan and the D·u
    residual u·sigmoid(u) unrounded (models/mamba.py): the port's bf16
    mixer lands within one bf16 rounding of the reference's, output and
    state."""
    jcfg, tcfg, jp, tp = _mamba_pair(seed=18)
    x = _x((2, T, tcfg.d_model), 19)
    st = _mamba_state(tcfg, 20)
    jst = {"conv": jnp.asarray(st["conv"], jnp.bfloat16),
           "ssm": jnp.asarray(st["ssm"])}
    chunk = 1 if T == 1 else 32
    want, wst = jax.jit(lambda p, x, s: jmamba.mamba_seq(
        jcfg, p, x, s, chunk=chunk))(jp, jnp.asarray(x, jnp.bfloat16), jst)
    bf16 = {k: (v if k in ("conv_b", "dt_bias", "A_log", "D")
                else v.to(torch.bfloat16)) for k, v in tp.items()}
    tst = {"conv": torch.tensor(st["conv"]).to(torch.bfloat16),
           "ssm": torch.tensor(st["ssm"])}
    got, gst = tmamba.mamba_seq(tcfg, bf16,
                                torch.tensor(x).to(torch.bfloat16), tst,
                                chunk=chunk)
    assert got.dtype == gst["conv"].dtype == torch.bfloat16
    assert gst["ssm"].dtype == torch.float32
    for a, b in ((got, want), (gst["ssm"], wst["ssm"]),
                 (gst["conv"], wst["conv"])):
        b = np.asarray(jnp.asarray(b, jnp.float32))
        assert np.abs(a.float().numpy() - b).max() \
            <= 2.0 ** -8 * np.abs(b).max()


# ------------------------------------------------------------------- MoE
def test_local_dispatch_matches_jax_and_the_dense_oracle():
    """Row-local dispatch with ample capacity is the dense oracle (the
    reference's tests/test_models.py check), and the reference's own row-
    local dispatch, on jamba's MoE (top-2 of 4 reduced) and llama4's (top-1
    with a shared expert)."""
    for arch in ("jamba-v0.1-52b", "llama4-maverick-400b-a17b"):
        jcfg, tcfg = _cfgs(arch)
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=16.0)) for c in (jcfg, tcfg))
        jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(21))
        tp = _tree(jp)
        x = _x((3, 24, tcfg.d_model), 22)
        got, aux = tmoe.apply_moe(tcfg, tp, torch.tensor(x),
                                  local_dispatch=True)
        want, waux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x),
                                    local_dispatch=True)
        _close(got, want)
        _close(aux.reshape(1), np.asarray([waux]))
        _close(got, tmoe.apply_moe_dense_oracle(tcfg, tp,
                                                torch.tensor(x)).numpy())


# -------------------------------------------------- gemma3's local rings
def test_gemma3_local_rings_past_the_window_match_jax():
    """A 128-token prompt at window 64: each local layer's ring holds
    min(C, 64) = 64 slots (S % C == 0: the last 64 positions), the global
    layer all 132; four decode steps wrap the rings (slot pos % 64) and
    attend every slot, as the reference does."""
    arch, B, S, gen = "gemma3-1b", 1, 128, 4
    jm = jax_build_model(arch, JaxOpts(dtype="float32", remat=False),
                         reduced=True)
    tm = build_model(arch, ModelOpts(dtype="float32"), reduced=True)
    assert tm.cfg.window == 64
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    prompts = np.random.default_rng(23).integers(
        0, tm.cfg.vocab, (B, S)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, t, cache_capacity=S + gen))(
        jparams, jnp.asarray(prompts))
    with torch.inference_mode():
        tl, tc = tm.prefill(tparams, torch.tensor(prompts), S + gen)
    _close(tl, jl)
    assert tc["stack/0/t0/k"].shape[1] == 64
    assert tc["stack/0/t5/k"].shape[1] == S + gen
    for i in range(gen):
        tok = np.full((B, 1), 7 + i, np.int32)
        jl, jc = jax.jit(jm.decode_step)(jparams, jnp.asarray(tok), jc,
                                         jnp.int32(S + i))
        with torch.inference_mode():
            tl, tc = tm.decode_step(tparams, torch.tensor(tok), tc, S + i)
        _close(tl, jl)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jc))
    for key in want:
        _close(tc[key], want[key])


# --------------------------------------------------------------- configs
def test_configs_match_jax_field_for_field():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert len(tconfigs.list_archs()) == 11
    for name in jconfigs.list_archs():
        j, t = jconfigs.get_config(name), tconfigs.get_config(name)
        for a, b in ((j, t), (j.reduced(), t.reduced())):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        assert t.pattern() == j.pattern()
        assert t.subquadratic() == j.subquadratic(), name
        for active in (False, True):
            assert t.param_count(active) == j.param_count(active), name
    assert {n for n in tconfigs.list_archs()
            if tconfigs.get_config(n).subquadratic()} == \
        {"gemma3-1b", "jamba-v0.1-52b", "rwkv6-1.6b"}
    assert tconfigs.get_config(
        "llama4-maverick-400b-a17b").param_count() == 397_691_453_440
    assert tconfigs.SHAPES.keys() == jconfigs.SHAPES.keys()
    for name, shape in tconfigs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jconfigs.SHAPES[name])


@pytest.mark.parametrize("arch", ["whisper-base", "paligemma-3b",
                                  "jamba-v0.1-52b"])
def test_frontend_stub_and_prefix_offset(arch):
    """The stub frontend's shape and value, as the reference's serve()
    builds it, and the decode offset it implies."""
    tm = build_model(arch, ModelOpts(dtype="float32"), reduced=True)
    fe = stub_frontend(tm.cfg, 3, "cpu")
    cfg = tm.cfg
    if cfg.frontend == "vision_stub":
        assert fe.shape == (3, cfg.frontend_tokens, cfg.frontend_dim)
        assert tm.n_prefix == cfg.frontend_tokens == 16
    elif cfg.frontend == "audio_stub":
        assert fe.shape == (3, cfg.enc_tokens, cfg.d_model)
        assert tm.n_prefix == 0
    else:
        assert fe is None and tm.n_prefix == 0
        return
    assert fe.dtype == torch.float32 and bool((fe == 0.02).all())
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="frontend"):
        tm.prefill(params, torch.zeros((3, 4), dtype=torch.long))


# ----------------------------------------------------------- checkpoints
@pytest.mark.parametrize("arch", ["whisper-base", "paligemma-3b"])
def test_convert_round_trip_is_the_identity(arch):
    jm = jax_build_model(arch, JaxOpts(dtype="float32"), reduced=True)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    flat = params_from_jax(tree)
    tm = build_model(arch, ModelOpts(dtype="float32"), reduced=True)
    template = tm.init(torch.Generator(), "cpu")
    assert sorted(flat) == sorted(template)
    assert all(flat[k].shape == template[k].shape for k in flat)
    if arch == "whisper-base":
        assert "enc/pos" in flat and "enc/stack/1/mixer/wq" in flat
        np.testing.assert_array_equal(
            flat["enc/stack/1/ffn/wi"].numpy(),
            tree["enc"]["stack"]["ffn"]["wi"][1])
    else:
        assert flat["projector"].shape == (1152, 128)
    back = flatten_tree(params_to_jax(flat))
    want = flatten_tree(tree)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def test_whisper_checkpoint_round_trip(tmp_path):
    tm = build_model("whisper-base", ModelOpts(dtype="float32"),
                     reduced=True)
    params = tm.init(torch.Generator().manual_seed(2), "cpu")
    path = save_checkpoint(str(tmp_path / "whisper"), params, step=3)
    got, step = load_checkpoint(path, params)
    assert step == 3 and sorted(got) == sorted(params)
    for k in params:
        assert torch.equal(got[k], params[k]), k
    # and the reference restores the port's archive
    from repro.checkpoint.ckpt import load_checkpoint as jax_load
    jm = jax_build_model("whisper-base", JaxOpts(dtype="float32"),
                         reduced=True)
    example = jm.init(jax.random.PRNGKey(0))
    restored, _ = jax_load(path, example)
    np.testing.assert_array_equal(
        np.asarray(restored["enc"]["stack"]["mixer"]["wq"][1]),
        params["enc/stack/1/mixer/wq"].numpy())
