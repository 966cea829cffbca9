"""The port's LM serving path against the JAX package on the CPU, for
the reduced() variant of each of the ten LMs: deepseek-moe-16b (a dense
layer 0 in the prefix, then one MoE super-block), smollm-360m (dense,
tied embeddings), rwkv6-1.6b (two RWKV-6 blocks, a recurrent cache),
gemma3-1b (five local layers, window 64, then a global one; one kv
head), stablelm-1.6b (layernorm, MHA), minicpm3-4b (MLA: a latent
cache), whisper-base (a two-layer encoder over the stub frames, decoder
blocks with cross attention and a GELU MLP), paligemma-3b (16 projected
stub patches prepended: the cache grows by them and decode positions
start after them), jamba-v0.1-52b (seven Mamba layers and one attention
layer, MoE on every other) and llama4-maverick-400b-a17b (a MoE layer
with a shared expert, then a dense one), in f32 and in bf16, on weights
carried across by checkpoint.convert.params_from_jax, with the
reference's stub frontend inputs:

  * prefill logits and the cache it emits (each entry in the reference's
    dtype for its key: an RWKV state S stays f32 under bf16);
  * five teacher-forced decode steps over a partly filled cache (the
    reference attends over all C slots, the zero slots not yet written
    included; the port keeps that quirk);
  * greedy generation (f32: the same tokens; bf16: tokens the
    reference's bf16 model rates within the tolerance of its best);
  * `make_cache` (an empty cache as the reference makes it) and decoding
    from it;
  * `serve()`'s output keys, the CLI on the CPU, and the CLI's `policy`
    forwarding.

Tolerance: f32 rtol = 2e-5, atol = 1e-5 x max|reference| (the same math
summed in another order; the reduced MoE's expert outputs reach ~10^2,
see tests/test_torch_moe.py), f32 tokens exact; bf16 below."""
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import serve as jax_serve
from repro.models import build_model as jax_build_model
from repro.models.model import ModelOpts as JaxOpts
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.kernels.flash_attention.kernel import flash_attention_hsd
from repro_torch.kernels.gmm.kernel import gmm_ecd
from repro_torch.kernels.wkv6.kernel import wkv6_btHN
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models.model import ModelOpts, build_model

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["deepseek-moe-16b", "smollm-360m", "rwkv6-1.6b", "gemma3-1b",
         "stablelm-1.6b", "minicpm3-4b", "whisper-base", "paligemma-3b",
         "jamba-v0.1-52b", "llama4-maverick-400b-a17b"]
B, S, GEN = 2, 6, 5
# bf16 against the reference's bf16 model, x max|reference|: logits
# 2^-5 (the two packages round and sum in different orders; measured up
# to 0.018 here, about as far as the reference's own bf16 logits land
# from its f32 logits: 0.013 in experiments/lm_bf16_drift.py
# --reduced), the cache 2^-6 (measured up to 0.0063)
BF16_LOGIT_TOL, BF16_CACHE_TOL = 2.0 ** -5, 2.0 ** -6
# a router near-tie: two gates closer than a few bf16 roundings of the
# router logits move them (~2^-8 relative, gates ~1/4 at E = 4)
ROUTER_TIE = 2.0 ** -8


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=2e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The reference's seed-0 weights of the reduced arch (its init reads
    only the config), made once for every test of the file."""
    jm = jax_build_model(arch, JaxOpts(remat=False), reduced=True)
    return jm.init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _pair(arch, use_kernels, dtype="float32"):
    """The two models on the same weights; the port's params are stored
    as its own init stores them (bf16 matrices, f32 norm scales under
    bf16), the reference's in f32, cast at use. Made once per arguments
    (the tests only read the models and the params)."""
    jm = jax_build_model(arch, JaxOpts(dtype=dtype, remat=False,
                                       use_kernels=use_kernels),
                         reduced=True)
    tm = build_model(arch, ModelOpts(dtype=dtype, use_kernels=use_kernels),
                     reduced=True)
    jparams = _jax_params(arch)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    template = tm.init(torch.Generator(), "cpu")
    assert sorted(template) == sorted(tparams)
    assert all(template[k].shape == tparams[k].shape for k in template)
    return jm, tm, jparams, {k: v.to(template[k].dtype)
                             for k, v in tparams.items()}


@functools.lru_cache(maxsize=None)
def _jprefill(jm, cap):
    """The reference's jitted prefill into `cap` slots, compiled once."""
    return jax.jit(lambda p, t, f: jm.prefill(p, t, f, cache_capacity=cap))


@functools.lru_cache(maxsize=None)
def _jdecode(jm):
    return jax.jit(jm.decode_step)


def _frontend(tm):
    """The stub frontend input, as the port's serve() makes it and as
    numpy for the reference (None without a frontend)."""
    fe = tserve.stub_frontend(tm.cfg, B, "cpu")
    return fe, (None if fe is None else jnp.asarray(fe.numpy()))


def _prompts(vocab, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _jax_cache(cache):
    """The reference's cache as the port keys it, in f32 (a bf16 cache
    widens exactly)."""
    return params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), cache))


def _assert_cache_dtypes(cache, jcache):
    """Each cache entry has the dtype the reference gives its key (an
    RWKV state S stays f32 under a bf16 model, as in the reference)."""
    want = {path[-1].key: str(leaf.dtype) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jcache)[0]}
    for key, t in cache.items():
        assert str(t.dtype) == "torch." + want[key.rsplit("/", 1)[-1]], key


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, use_kernels):
    jm, tm, jparams, tparams = _pair(arch, use_kernels)
    prompts = _prompts(tm.cfg.vocab)
    fe, jfe = _frontend(tm)
    cap, P = S + GEN, tm.n_prefix
    jlogits, jcache = _jprefill(jm, cap)(jparams, jnp.asarray(prompts), jfe)
    flash_attention_hsd.launches = gmm_ecd.launches = 0
    wkv6_btHN.launches = 0
    with torch.inference_mode():
        logits, cache = tm.prefill(tparams, torch.tensor(prompts), cap,
                                   frontend=fe)
    assert logits.shape == (B, 1, tm.cfg.vocab)
    _close(logits, jlogits)
    want = _jax_cache(jcache)
    assert sorted(cache) == sorted(want)
    assert all(cache[k].shape == want[k].shape for k in want)
    for k in want:
        _close(cache[k], want[k])

    # teacher-forced decode over a cache with P + S + i of its slots
    # written: the zero slots are attended too, in both packages
    forced = np.random.default_rng(8).integers(
        0, tm.cfg.vocab, (GEN, B, 1)).astype(np.int32)
    jdecode = _jdecode(jm)
    for i in range(GEN):
        jlogits, jcache = jdecode(jparams, jnp.asarray(forced[i]), jcache,
                                  jnp.int32(P + S + i))
        with torch.inference_mode():
            logits, cache = tm.decode_step(tparams, torch.tensor(forced[i]),
                                           cache, P + S + i)
        _close(logits, jlogits)
    want = _jax_cache(jcache)
    for k in want:
        _close(cache[k], want[k])
    assert flash_attention_hsd.launches == gmm_ecd.launches == \
        wkv6_btHN.launches == 0  # CPU


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(arch):
    jm, tm, jparams, tparams = _pair(arch, True)
    prompts = _prompts(tm.cfg.vocab, seed=9)
    fe, jfe = _frontend(tm)
    gen = 8
    jlogits, jcache = _jprefill(jm, S + gen)(jparams, jnp.asarray(prompts),
                                             jfe)
    jdecode = _jdecode(jm)
    tok = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]
    want = []
    for i in range(gen):
        jlogits, jcache = jdecode(jparams, tok, jcache,
                                  jnp.int32(tm.n_prefix + S + i))
        tok = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]
        want.append(np.asarray(tok))
    got = tserve.generate(tm, tparams, torch.tensor(prompts), gen,
                          frontend=fe)
    assert np.array_equal(got["tokens"].numpy(), np.concatenate(want, 1))


def _bf16_close(got, want, tol):
    """|port - reference| <= tol x max|reference|, both widened to f32."""
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _near_best(pick, jlogits):
    """Each row's token `pick` (B,) is one the reference's bf16 model
    rates within BF16_LOGIT_TOL x max|logit| of its best (a bf16 near-tie
    may go either way)."""
    want = np.asarray(jlogits, np.float32)[:, -1]
    slack = BF16_LOGIT_TOL * np.abs(want).max()
    assert (want[np.arange(len(pick)), pick] >= want.max(-1) - slack).all()


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_jax(arch, use_kernels):
    """The card's dtype on the CPU: the port's bf16 model (bf16 matrices
    stored once) against the reference's bf16 model (f32 weights cast at
    use) on the same weights, prefill and five teacher-forced decode
    steps, logits and cache."""
    jm, tm, jparams, tparams = _pair(arch, use_kernels, "bfloat16")
    prompts = _prompts(tm.cfg.vocab)
    fe, jfe = _frontend(tm)
    cap, P = S + GEN, tm.n_prefix
    jlogits, jcache = _jprefill(jm, cap)(jparams, jnp.asarray(prompts), jfe)
    with torch.inference_mode():
        logits, cache = tm.prefill(tparams, torch.tensor(prompts), cap,
                                   frontend=fe)
    assert logits.dtype == torch.bfloat16
    _bf16_close(logits, jlogits, BF16_LOGIT_TOL)
    _near_best(logits[:, -1].float().argmax(-1).numpy(), jlogits)
    want = _jax_cache(jcache)
    _assert_cache_dtypes(cache, jcache)
    for k in want:
        _bf16_close(cache[k], want[k], BF16_CACHE_TOL)
    forced = np.random.default_rng(8).integers(
        0, tm.cfg.vocab, (GEN, B, 1)).astype(np.int32)
    jdecode = _jdecode(jm)
    for i in range(GEN):
        jlogits, jcache = jdecode(jparams, jnp.asarray(forced[i]), jcache,
                                  jnp.int32(P + S + i))
        with torch.inference_mode():
            logits, cache = tm.decode_step(tparams, torch.tensor(forced[i]),
                                           cache, P + S + i)
        _bf16_close(logits, jlogits, BF16_LOGIT_TOL)
        _near_best(logits[:, -1].float().argmax(-1).numpy(), jlogits)
    want = _jax_cache(jcache)
    for k in want:
        _bf16_close(cache[k], want[k], BF16_CACHE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_greedy_tokens_are_the_references_best(arch, monkeypatch):
    """The port generates greedily in bf16; the reference's bf16 model,
    fed the same tokens, rates every token the port picked within the
    bf16 tolerance of its own best, except at a step where the port's
    router met a near-tie (the K-th and K+1-th gates of a token within
    ROUTER_TIE): there one rounding sends the token to another expert.
    The reduced deepseek's one MoE layer is its last, so such a flip
    moves that step's logits only. At this seed one does (the second
    decode step, a gate margin of 2e-4), and two of the nine steps are
    exempt."""
    jm, tm, jparams, tparams = _pair(arch, True, "bfloat16")
    margins = []  # per router call: min over tokens of gate[K-1] - gate[K]
    route = tmoe._route

    def recording_route(cfg, p, xt):
        gates, topv, topi = route(cfg, p, xt)
        g = torch.sort(gates, dim=-1, descending=True).values
        K = cfg.moe.top_k
        margins.append(float((g[:, K - 1] - g[:, K]).min()))
        return gates, topv, topi

    monkeypatch.setattr(tmoe, "_route", recording_route)
    prompts = _prompts(tm.cfg.vocab, seed=9)
    fe, jfe = _frontend(tm)
    gen = 8
    got = tserve.generate(tm, tparams, torch.tensor(prompts), gen,
                          frontend=fe)["tokens"]
    n_moe = sum(map(tm.cfg.is_moe_layer, range(tm.cfg.n_layers)))
    assert len(margins) == n_moe * (gen + 1)
    with torch.inference_mode():  # the token fed to the first decode step
        first = tm.prefill(tparams, torch.tensor(prompts), S + gen,
                           frontend=fe)[0]
    fed = torch.cat([first[:, -1].float().argmax(-1)[:, None], got], 1)
    jlogits, jcache = _jprefill(jm, S + gen)(jparams, jnp.asarray(prompts),
                                             jfe)
    jdecode = _jdecode(jm)
    flips = 0
    for i in range(gen + 1):
        tie = min(margins[i * n_moe:(i + 1) * n_moe], default=1.0)
        if tie < ROUTER_TIE:
            flips += 1
        else:
            _near_best(fed[:, i].numpy(), jlogits)
        if i < gen:
            jlogits, jcache = jdecode(jparams,
                                      jnp.asarray(fed[:, i:i + 1].numpy()),
                                      jcache, jnp.int32(tm.n_prefix + S + i))
    assert 2 * flips < gen + 1  # most steps are held


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_cache_matches_jax_and_decodes_from_empty(arch, dtype):
    """An empty cache: the reference's keys, shapes, dtype and zeros; and
    three decode steps from position 0 on it give the reference's
    logits (f32)."""
    jm, tm, jparams, tparams = _pair(arch, False)
    cap = 4
    jcache = jax_build_model(arch, JaxOpts(dtype=dtype),
                             reduced=True).make_cache(B, cap)
    cache = build_model(arch, ModelOpts(dtype=dtype),
                        reduced=True).make_cache(B, cap, "cpu")
    want = _jax_cache(jcache)
    assert sorted(cache) == sorted(want)
    _assert_cache_dtypes(cache, jcache)
    for k in want:
        assert cache[k].shape == want[k].shape
        assert not cache[k].any() and not want[k].any()
    if dtype != "float32":
        return
    jcache = jm.make_cache(B, cap)
    tokens = _prompts(tm.cfg.vocab, seed=10)[:, :3, None]
    jdecode = _jdecode(jm)
    for i in range(3):
        jlogits, jcache = jdecode(jparams, jnp.asarray(tokens[:, i]),
                                  jcache, jnp.int32(i))
        with torch.inference_mode():
            logits, cache = tm.decode_step(tparams, torch.tensor(tokens[:, i]),
                                           cache, i)
        _close(logits, jlogits)


def test_serve_output_keys_match_jax():
    want = jax_serve(reduced=True, batch=2, prompt_len=4, gen_len=3)
    got = tserve.serve(reduced=True, batch=2, prompt_len=4, gen_len=3,
                       device="cpu")
    assert set(got) == set(want) | {"device"}
    assert got["generated_shape"] == want["generated_shape"] == [2, 3]
    assert got["arch"] == "smollm-360m" and got["device"] == "cpu"
    assert len(got["sample"]) == 3 and got["decode_tok_per_s"] > 0
    for k in ("warmup_s", "prefill_s"):
        assert got[k] >= 0


def test_serve_with_given_params_and_prompts_is_greedy_deterministic():
    tm = build_model("deepseek-moe-16b", ModelOpts(dtype="float32"),
                     reduced=True)
    params = tm.init(torch.Generator().manual_seed(3), "cpu")
    prompts = torch.tensor(_prompts(tm.cfg.vocab))
    runs = [tserve.serve("deepseek-moe-16b", batch=B, prompt_len=S,
                         gen_len=4, temperature=0.0, device="cpu",
                         use_kernels=True, params=params, prompts=prompts)
            for _ in range(2)]
    want = tserve.generate(tm, params, prompts, 4)["tokens"]
    assert runs[0]["sample"] == runs[1]["sample"] == want[0].tolist()


def test_cli_serves_reduced_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--gen-len", "4"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["generated_shape"] == [2, 4] and res["device"] == "cpu"


def test_cli_forwards_policy_to_serve_policy(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main(["policy", "--device", "cpu", "--train-iters", "0",
                     "--load", "4000", "--buckets", "4", "--requests", "8",
                     "--out", str(tmp_path)])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["source"] == "fresh-init" and out["device"] == "cpu"
    assert out["recompiles_after_warmup"] == 0

