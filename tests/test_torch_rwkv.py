"""The port's RWKV-6 model against the JAX package on the CPU, at the
reduced rwkv6-1.6b width (d_model 128, 4 heads of 32, d_ff 128, two
layers), on the same weights (checkpoint.convert.params_from_jax):

  * the model functions: `_ddlerp`/`_rkvwg`, `wkv_chunked` with a carried
    state, `rwkv_time_mix_seq` (through the kernel seam and without it),
    `rwkv_channel_mix`, and one RWKV block in its sequence and decode
    modes;
  * decoding token by token equals one chunked pass
    (tests/test_models.py::test_rwkv_decode_chain_matches_seq), through
    the port's seam with use_kernels on and off;
  * the slice as a whole: prefill and five teacher-forced decode steps,
    logits and every cache entry, use_kernels on and off, in f32 and in
    bf16; `serve()` and the CLI on the CPU; the params round trip.

The reference's init leaves u = 0 (no diagonal bonus), w0 = -6 (every
decay ~0.9975), unit head-norm scales and lerps at 0.5, which would hide
a wrong u-term or decay: every test redraws those constants from a numpy
seed in both packages' params before comparing.

Tolerances: f32 rtol = 2e-5, atol = 1e-5 x max|reference| (the same
math summed in another order), the WKV's own atol = 2e-4, rtol = 1e-3
(tests/test_kernels.py); bf16 those of tests/test_torch_lm_serve.py
(logits 2^-5, cache 2^-6, x max|reference|; the state S is compared in
f32 as both packages keep it)."""
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RWKV as JAX_RWKV
from repro.configs.base import get_config as jax_get_config
from repro.models import blocks as jblocks
from repro.models import build_model as jax_build_model
from repro.models import rwkv6 as jrwkv
from repro.models.attention import AttnOpts as JaxAttnOpts
from repro.models.model import ModelOpts as JaxOpts
from repro_torch.checkpoint.convert import params_from_jax, params_to_jax
from repro_torch.configs.base import RWKV, get_config
from repro_torch.kernels.wkv6.kernel import wkv6_btHN
from repro_torch.launch import serve as tserve
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.attention import AttnOpts
from repro_torch.models.blocks import Block
from repro_torch.models.layers import apply_params
from repro_torch.models.model import ModelOpts, build_model

CFG = get_config("rwkv6-1.6b").reduced()
JCFG = jax_get_config("rwkv6-1.6b").reduced()
B, S, GEN = 2, 6, 5
WKV_TOL = dict(atol=2e-4, rtol=1e-3)
BF16_LOGIT_TOL, BF16_CACHE_TOL = 2.0 ** -5, 2.0 ** -6
# the constants the reference's init leaves trivial, and their redraws
PERTURB = {"u": lambda rng, s: 0.5 * rng.standard_normal(s),
           "w0": lambda rng, s: rng.uniform(-5.0, 1.0, s),
           "ln_scale": lambda rng, s: 1.0 + 0.2 * rng.standard_normal(s),
           "mu": lambda rng, s: rng.uniform(0.0, 1.0, s),
           "cm_mu": lambda rng, s: rng.uniform(0.0, 1.0, s)}


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=2e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _bf16_close(got, want, tol):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _perturbed(tree, seed=0):
    """A numpy copy of a reference param tree with the RWKV constants
    redrawn (same shapes, f32)."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        arr = np.asarray(node)
        if name in PERTURB:
            arr = PERTURB[name](rng, arr.shape).astype(np.float32)
        return arr
    return walk(jax.tree_util.tree_map(np.asarray, tree))


def _mixer(seed=0):
    """One RWKV mixer's params: (reference dict, port flat dict)."""
    jp = _perturbed(jrwkv.init_rwkv(JCFG, jax.random.PRNGKey(seed)), seed)
    return jax.tree_util.tree_map(jnp.asarray, jp), params_from_jax(jp)


def _x(T, seed=1, d=CFG.d_model):
    return np.random.default_rng(seed).standard_normal((B, T, d)).astype(
        np.float32)


def _state(seed=2):
    rng = np.random.default_rng(seed)
    H, N = CFG.n_heads, CFG.head_dim
    return ((0.3 * rng.standard_normal((B, H, N, N))).astype(np.float32),
            rng.standard_normal((B, CFG.d_model)).astype(np.float32))


def test_ddlerp_and_rkvwg_match_jax():
    jp, tp = _mixer()
    x, prev = _x(7), _x(7, seed=3)
    want = jrwkv._ddlerp(jp, jnp.asarray(x), jnp.asarray(prev))
    got = trwkv._ddlerp(tp, torch.tensor(x), torch.tensor(prev))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g, w)
    want = jrwkv._rkvwg(JCFG, jp, jnp.asarray(x), jnp.asarray(prev))
    got = trwkv._rkvwg(CFG, tp, torch.tensor(x), torch.tensor(prev))
    for g, w in zip(got, want):  # r, k, v, g, logw
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("T,chunk", [(50, 16), (37, 16), (5, 64)])
def test_wkv_chunked_matches_jax_with_a_carried_state(T, chunk):
    rng = np.random.default_rng(T)
    H, N = 2, 16
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(0.5 * rng.standard_normal((B, T, H, N))).astype(
        np.float32)
    u = (0.2 * rng.standard_normal((H, N))).astype(np.float32)
    s0 = (0.2 * rng.standard_normal((B, H, N, N))).astype(np.float32)
    args = (r, k, v, logw, u, s0)
    jy, jS = jrwkv.wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    y, S2 = trwkv.wkv_chunked(*map(torch.tensor, args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **WKV_TOL)
    np.testing.assert_allclose(S2.numpy(), np.asarray(jS), **WKV_TOL)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("T,chunk", [(9, 4), (1, 1)])
def test_time_mix_matches_jax(T, chunk, use_kernels):
    jp, tp = _mixer()
    x = _x(T)
    S0, shift = _state()
    out, st = jrwkv.rwkv_time_mix_seq(
        JCFG, jp, jnp.asarray(x), {"S": jnp.asarray(S0),
                                   "shift": jnp.asarray(shift)}, chunk)
    wkv6_btHN.launches = 0
    got, gst = trwkv.rwkv_time_mix_seq(
        CFG, tp, torch.tensor(x), {"S": torch.tensor(S0),
                                   "shift": torch.tensor(shift)}, chunk,
        use_kernels=use_kernels)
    assert wkv6_btHN.launches == 0  # the CPU takes the plain version
    _close(got, out)
    np.testing.assert_allclose(gst["S"].numpy(), np.asarray(st["S"]),
                               **WKV_TOL)
    _close(gst["shift"], st["shift"])


def test_channel_mix_matches_jax():
    jp, tp = _mixer()
    x = _x(8)
    _, shift = _state()
    out, sh = jrwkv.rwkv_channel_mix(JCFG, jp, jnp.asarray(x),
                                     jnp.asarray(shift))
    got, gsh = trwkv.rwkv_channel_mix(CFG, tp, torch.tensor(x),
                                      torch.tensor(shift))
    _close(got, out)
    _close(gsh, sh)


def _block(use_kernels):
    jp = _perturbed(jblocks.init_block(JCFG, jax.random.PRNGKey(4), JAX_RWKV,
                                       False))
    blk = Block(CFG, RWKV, False, AttnOpts(dtype=torch.float32,
                                           use_kernels=use_kernels))
    return jax.tree_util.tree_map(jnp.asarray, jp), blk, params_from_jax(jp)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_block_seq_and_decode_match_jax(use_kernels):
    """One RWKV block: the sequence mode from a zero state (its emitted
    cache too), then three decode steps carrying that cache in place."""
    jp, blk, tp = _block(use_kernels)
    jopts = JaxAttnOpts(dtype=jnp.float32)
    x = _x(S, seed=5)
    jx, jcache, _ = jblocks.apply_block_seq(JCFG, jp, JAX_RWKV, False,
                                            jnp.asarray(x), 0, jopts,
                                            cache_capacity=S + GEN)
    with torch.inference_mode():
        got, cache, aux = apply_params(blk, tp, torch.tensor(x), 0, S + GEN)
    assert aux == 0.0 and sorted(cache) == sorted(jcache)
    _close(got, jx)
    for k in jcache:
        _close(cache[k], jcache[k])
    for i in range(3):
        xt = _x(1, seed=10 + i)
        jx, jcache, _ = jblocks.apply_block_decode(
            JCFG, jp, JAX_RWKV, False, jnp.asarray(xt), jcache, S + i, jopts)
        ptr = cache["S"].data_ptr()
        with torch.inference_mode():
            got, cache2, _ = apply_params(blk, tp, torch.tensor(xt),
                                          cache=cache, pos=S + i)
        assert cache2 is cache and cache["S"].data_ptr() == ptr  # in place
        _close(got, jx)
        for k in jcache:
            _close(cache[k], jcache[k])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_decode_chain_matches_one_chunked_pass(use_kernels):
    """Token by token at chunk 1 equals one chunked pass (the reference's
    test_rwkv_decode_chain_matches_seq), through the port's time mix."""
    _, tp = _mixer(seed=6)
    x = torch.tensor(_x(12, seed=7))
    S0, shift = map(torch.tensor, _state(seed=8))
    with torch.inference_mode():
        y_all, st_all = trwkv.rwkv_time_mix_seq(
            CFG, tp, x, {"S": S0.clone(), "shift": shift}, 4,
            use_kernels=use_kernels)
        st = {"S": S0.clone(), "shift": shift}
        ys = []
        for t in range(12):
            y, new = trwkv.rwkv_time_mix_seq(
                CFG, tp, x[:, t:t + 1], st, 1, use_kernels=use_kernels)
            if use_kernels:  # the WKV wrote S over the state it was given
                assert new["S"] is st["S"]
            st = {"S": new["S"], "shift": new["shift"]}
            ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_all.numpy(),
                               **WKV_TOL)
    np.testing.assert_allclose(st["S"].numpy(), st_all["S"].numpy(),
                               **WKV_TOL)


def _pair(use_kernels, dtype):
    """The reduced rwkv6-1.6b in both packages on the same perturbed
    weights; the port's stored as its own init stores them."""
    jm = jax_build_model("rwkv6-1.6b", JaxOpts(dtype=dtype, remat=False),
                         reduced=True)
    tm = build_model("rwkv6-1.6b", ModelOpts(dtype=dtype,
                                             use_kernels=use_kernels),
                     reduced=True)
    tree = _perturbed(jm.init(jax.random.PRNGKey(0)))
    template = tm.init(torch.Generator(), "cpu")
    tparams = params_from_jax(tree)
    assert sorted(template) == sorted(tparams)
    return (jm, tm, jax.tree_util.tree_map(jnp.asarray, tree),
            {k: v.to(template[k].dtype) for k, v in tparams.items()})


def _jax_cache(cache):
    return params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), cache))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_and_decode_match_jax_with_perturbed_constants(use_kernels,
                                                               dtype):
    jm, tm, jparams, tparams = _pair(use_kernels, dtype)
    prompts = np.random.default_rng(7).integers(
        0, CFG.vocab, (B, S)).astype(np.int32)
    forced = np.random.default_rng(8).integers(
        0, CFG.vocab, (GEN, B, 1)).astype(np.int32)
    bf16 = dtype == "bfloat16"

    def logits_close(got, want):
        if bf16:
            _bf16_close(got, want, BF16_LOGIT_TOL)
        else:
            _close(got, want)

    def cache_close(cache, jcache):
        want = _jax_cache(jcache)
        assert sorted(cache) == sorted(want)
        for k, w in want.items():
            assert cache[k].dtype == (torch.float32 if k.endswith("/S")
                                      else getattr(torch, dtype))
            if bf16:
                _bf16_close(cache[k], w, BF16_CACHE_TOL)
            else:
                _close(cache[k], w)

    jlogits, jcache = jax.jit(lambda p, t: jm.prefill(
        p, t, cache_capacity=S + GEN))(jparams, jnp.asarray(prompts))
    with torch.inference_mode():
        logits, cache = tm.prefill(tparams, torch.tensor(prompts), S + GEN)
    logits_close(logits, jlogits)
    cache_close(cache, jcache)
    jdecode = jax.jit(jm.decode_step)
    for i in range(GEN):
        jlogits, jcache = jdecode(jparams, jnp.asarray(forced[i]), jcache,
                                  jnp.int32(S + i))
        with torch.inference_mode():
            logits, cache = tm.decode_step(tparams, torch.tensor(forced[i]),
                                           cache, S + i)
        logits_close(logits, jlogits)
    cache_close(cache, jcache)


def test_params_round_trip_and_storage_dtypes():
    """The stacked (2, ...) leaves and the 3-D mix_b split per block and
    restack bitwise; under bf16 the matrices are stored in bf16 but the
    leaves the reference reads in f32 (wa, wb and the constants) in f32."""
    tree = jax.tree_util.tree_map(
        np.asarray, jax_build_model("rwkv6-1.6b", reduced=True).init(
            jax.random.PRNGKey(0)))
    flat = params_from_jax(tree)
    assert flat["stack/1/t0/mixer/mix_b"].shape == (5, 32, CFG.d_model)
    np.testing.assert_array_equal(flat["stack/1/t0/mixer/mix_b"].numpy(),
                                  tree["stack"]["t0"]["mixer"]["mix_b"][1])
    back = params_to_jax(flat)
    la, ta = jax.tree_util.tree_flatten_with_path(back)
    lb, tb = jax.tree_util.tree_flatten_with_path(tree)
    assert ta == tb
    for (pa, a), (_, b) in zip(la, lb):
        assert a.dtype == b.dtype, pa
        np.testing.assert_array_equal(a, b)
    tm = build_model("rwkv6-1.6b", ModelOpts(dtype="bfloat16"),
                     reduced=True)
    template = tm.init(torch.Generator(), "cpu")
    f32 = {"mu", "w0", "wa", "wb", "u", "ln_scale", "cm_mu", "scale",
           "bias"}
    for k, v in template.items():
        want = torch.float32 if k.rsplit("/", 1)[-1] in f32 \
            else torch.bfloat16
        assert v.dtype == want, k


def test_param_count_is_the_references():
    full = jax_get_config("rwkv6-1.6b")
    assert get_config("rwkv6-1.6b").param_count() == full.param_count()
    cfg = dataclasses.replace(full, n_layers=3, d_ff=96)
    assert dataclasses.replace(get_config("rwkv6-1.6b"), n_layers=3,
                               d_ff=96).param_count() == cfg.param_count()


def test_serve_and_cli_run_reduced_on_the_cpu():
    wkv6_btHN.launches = 0
    res = tserve.serve("rwkv6-1.6b", batch=2, prompt_len=5, gen_len=3,
                       device="cpu", use_kernels=True)
    assert res["generated_shape"] == [2, 3] and res["device"] == "cpu"
    assert wkv6_btHN.launches == 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main(["--arch", "rwkv6-1.6b", "--reduced", "--device", "cpu",
                     "--use-kernels", "--batch", "2", "--prompt-len", "70",
                     "--gen-len", "2"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["arch"] == "rwkv6-1.6b" and out["generated_shape"] == [2, 2]
