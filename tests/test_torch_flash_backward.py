"""The flash-attention backward's plain version and the autograd Function
around the kernel, on the CPU:

  (a) `attention_bwd_ref` (from `attention_lse_ref`'s o and lse) against
      `jax.vjp` of the reference's oracle
      (repro.kernels.flash_attention.ref.attention_ref) at S 1-32, G 1-4,
      D 16-256, causal, windowed and non-causal; `valid_len` (which the
      oracle lacks) against the oracle on the keys below it, non-causal;
  (b) the same against torch autograd through the port's attention_ref,
      causal and windowed with `valid_len` too; a row with no key gets
      zero gradients; lse against a float64 log-sum-exp;
  (c) `_FlashAttention` on CPU tensors (its wrappers take the plain
      versions there) on the model layout against autograd through the
      dispatcher's plain path, with a strided cotangent; the kernel
      wrappers on CPU tensors launch nothing.

Tolerance: f32, atol = rtol = 2e-5 (tests/test_kernels.py's, the same
math summed in another order); lse within 1e-5 of float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.core.attention import attention
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd, flash_attention_fwd_lse, flash_attention_hsd)
from repro_torch.kernels.flash_attention.ops import (_FlashAttention,
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

TOL = dict(atol=2e-5, rtol=2e-5)

# S, G, D, causal, window: S 1-32, G 1-4, D 16-256
CASES = [(1, 1, 16, True, 0), (3, 2, 32, True, 0), (4, 2, 64, True, 0),
         (4, 2, 32, False, 0), (5, 3, 128, True, 2), (8, 4, 16, False, 0),
         (17, 1, 64, True, 0), (17, 2, 256, True, 5), (24, 4, 32, False, 0),
         (32, 2, 64, True, 0), (32, 1, 256, False, 0), (32, 4, 16, True, 8),
         (3, 2, 64, True, 0), (12, 3, 64, True, 1)]
IDS = [f"S{c[0]}-G{c[1]}-D{c[2]}-c{int(c[3])}-w{c[4]}" for c in CASES]
# S, G, D, valid_len (non-causal: the oracle on the keys below valid_len)
VALID_CASES = [(20, 2, 32, 7), (32, 3, 64, 29), (6, 1, 16, 1),
               (4, 2, 64, 3)]
B, KVH = 2, 2


def _inputs(S, G, D, seed):
    rng = np.random.default_rng(seed)
    H = KVH * G
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    do = rng.standard_normal((B, H, S, D)).astype(np.float32)
    return q, k, v, do


def _ref_grads(q, k, v, do, **mask):
    """attention_bwd_ref from attention_lse_ref's o and lse, as numpy."""
    t = [torch.tensor(a) for a in (q, k, v, do)]
    o, lse = attention_lse_ref(*t[:3], **mask)
    return [g.numpy() for g in attention_bwd_ref(*t[:3], o, lse, t[3],
                                                 **mask)]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("S,G,D,causal,window", CASES, ids=IDS)
def test_bwd_ref_matches_jax_vjp(S, G, D, causal, window):
    q, k, v, do = _inputs(S, G, D, S + G + D)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, causal=causal,
                                             window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(_ref_grads(q, k, v, do, causal=causal, window=window),
           vjp(jnp.asarray(do)))


@pytest.mark.parametrize("S,G,D,valid_len", VALID_CASES)
def test_bwd_ref_valid_len_matches_jax_on_the_valid_keys(S, G, D,
                                                         valid_len):
    q, k, v, do = _inputs(S, G, D, 7 * S + G)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, causal=False),
                     jnp.asarray(q), jnp.asarray(k[:, :, :valid_len]),
                     jnp.asarray(v[:, :, :valid_len]))
    dq, dk, dv = vjp(jnp.asarray(do))
    pad = np.zeros((B, KVH, S - valid_len, D), np.float32)
    want = (dq, np.concatenate([dk, pad], 2), np.concatenate([dv, pad], 2))
    _close(_ref_grads(q, k, v, do, causal=False, valid_len=valid_len), want)


# causal, window, valid_len as a function of S: every row keeps a key
# (the plain softmax spreads a row without one over every key)
MASKS = {"causal": lambda S: (True, 0, None),
         "window": lambda S: (True, 3, None),
         "full": lambda S: (False, 0, None),
         "causal-valid": lambda S: (True, 0, max(1, S // 2)),
         "window-valid": lambda S: (True, 4, S - 1),
         "full-window-valid": lambda S: (False, 2, S - 1)}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("S,G,D", [(4, 2, 64), (3, 2, 32), (13, 3, 32),
                                   (32, 1, 128)])
def test_bwd_ref_matches_torch_autograd(S, G, D, mask):
    q, k, v, do = _inputs(S, G, D, S * G + D)
    mask = dict(zip(("causal", "window", "valid_len"), MASKS[mask](S)))
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = attention_ref(*t, **mask)
    want = torch.autograd.grad(o, t, torch.tensor(do))
    _close(_ref_grads(q, k, v, do, **mask), [w.numpy() for w in want])


def test_lse_ref_is_the_rows_log_sum_exp():
    S, G, D = 9, 2, 32
    q, k, v, _ = _inputs(S, G, D, 3)
    _, lse = attention_lse_ref(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), causal=True, window=4)
    kk = np.repeat(k, G, axis=1).astype(np.float64)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64) * D ** -0.5, kk)
    qi, ki = np.arange(S)[:, None], np.arange(S)[None, :]
    s = np.where((ki <= qi) & (ki > qi - 4), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
        s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-5)


def test_bwd_ref_row_without_keys_gets_zero_gradients():
    """window 1 with valid_len 2: rows at qpos >= 2 attend no key; their
    dq is zero, their lse -inf, and they add nothing to dk, dv."""
    S, G, D = 5, 2, 32
    q, k, v, do = _inputs(S, G, D, 11)
    mask = dict(causal=True, window=1, valid_len=2)
    t = [torch.tensor(a) for a in (q, k, v, do)]
    o, lse = attention_lse_ref(*t[:3], **mask)
    assert bool(torch.isneginf(lse[:, :, 2:]).all())
    dq, dk, dv = attention_bwd_ref(*t[:3], o, lse, t[3], **mask)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert bool((dq[:, :, 2:] == 0).all())
    assert bool((dk[:, :, 2:] == 0).all()) and bool((dv[:, :, 2:] == 0).all())
    # the rows with keys alone give the same dk, dv
    cut = [torch.tensor(a)[:, :, :2] for a in (q, do)]
    o2, lse2 = attention_lse_ref(cut[0], t[1][:, :, :2], t[2][:, :, :2],
                                 **mask)
    _, dk2, dv2 = attention_bwd_ref(cut[0], t[1][:, :, :2], t[2][:, :, :2],
                                    o2, lse2, cut[1], **mask)
    torch.testing.assert_close(dk[:, :, :2], dk2, **TOL)
    torch.testing.assert_close(dv[:, :, :2], dv2, **TOL)


@pytest.fixture
def no_launches():
    for f in (flash_attention_hsd, flash_attention_fwd_lse,
              flash_attention_bwd):
        f.launches = 0
    yield
    assert (flash_attention_hsd.launches, flash_attention_fwd_lse.launches,
            flash_attention_bwd.launches) == (0, 0, 0)


@pytest.mark.parametrize("S,G,D", [(4, 2, 64), (3, 2, 32), (17, 3, 16)])
def test_function_matches_plain_autograd_on_the_model_layout(S, G, D,
                                                             no_launches):
    rng = np.random.default_rng(S + G)
    qg = rng.standard_normal((B, S, KVH, G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    # a strided cotangent with a contiguous head dim, as autograd may give
    dout = torch.tensor(rng.standard_normal((B, KVH, S, G, D)).astype(
        np.float32)).permute(0, 2, 1, 3, 4)
    ins = [torch.tensor(a, requires_grad=True) for a in (qg, k, v)]
    out = _FlashAttention.apply(*ins, True, 0)
    got = torch.autograd.grad(out, ins, dout)
    ref_ins = [torch.tensor(a, requires_grad=True) for a in (qg, k, v)]
    ref = attention(*ref_ins, causal=True, use_kernel=False)
    want = torch.autograd.grad(ref, ref_ins, dout)
    torch.testing.assert_close(out, ref, **TOL)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, **TOL)
    # the public entry trains through the plain version on the CPU
    ins2 = [torch.tensor(a, requires_grad=True) for a in (qg, k, v)]
    out2 = flash_attention(*ins2)
    for g, w in zip(torch.autograd.grad(out2, ins2, dout), want):
        torch.testing.assert_close(g, w, **TOL)


def test_cpu_wrappers_take_the_plain_versions(no_launches):
    q, k, v, do = (torch.tensor(a) for a in _inputs(4, 2, 64, 5))
    o, lse = flash_attention_fwd_lse(q, k, v, valid_len=3)
    o_ref, lse_ref = attention_lse_ref(q, k, v, valid_len=3)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    got = flash_attention_bwd(q, k, v, o, lse, do, valid_len=3)
    want = attention_bwd_ref(q, k, v, o, lse, do, valid_len=3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
