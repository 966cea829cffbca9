"""The port's flash attention (repro_torch.kernels.flash_attention and the
core.attention dispatcher) against the JAX package: the Pallas kernel in
interpret mode, its padding wrapper, and the jnp oracle. Every case
groups query heads (G >= 2), so a wrong head order cannot pass.

Tolerance: f32 atol = rtol = 2e-5 (tests/test_kernels.py), the same math
summed in another order. On the CPU the wrapper takes the plain version,
so the kernel's launch counter stays at 0; the kernel itself is held to
the plain version in tests/test_torch_kernels_cuda.py, on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.attention import attention as jax_attention
from repro.kernels.flash_attention.kernel import \
    flash_attention_hsd as jax_flash_hsd
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.core.attention import attention
from repro_torch.kernels.flash_attention.kernel import flash_attention_hsd
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = dict(atol=2e-5, rtol=2e-5)

# B, KVH, G, S, D, causal, window
CASES = [
    (2, 2, 2, 16, 16, True, 0),      # causal, G=2
    (1, 1, 4, 24, 32, True, 8),      # sliding window, G=4
    (2, 2, 2, 13, 32, False, 0),     # non-causal, ragged S
    (1, 2, 4, 21, 16, True, 0),      # causal, ragged S, G=4
    (2, 1, 2, 4, 32, True, 0),       # the serving shape's S=4
]
IDS = [f"B{c[0]}-KVH{c[1]}-G{c[2]}-S{c[3]}-D{c[4]}-c{int(c[5])}-w{c[6]}"
       for c in CASES]


def _inputs(B, KVH, G, S, D, seed=0):
    rng = np.random.default_rng(seed)
    qg = rng.standard_normal((B, S, KVH, G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    return qg, k, v


def _hsd(qg, k, v):
    """Model layout -> (B,H,S,D) q and (B,KVH,S,D) k, v, h = kvh*G + g."""
    B, S, KVH, G, D = qg.shape
    q = qg.reshape(B, S, KVH * G, D).swapaxes(1, 2)
    return q, k.swapaxes(1, 2), v.swapaxes(1, 2)


@pytest.fixture(autouse=True)
def _count_from_zero():
    flash_attention_hsd.launches = 0
    yield
    assert flash_attention_hsd.launches == 0, "a CPU call launched a kernel"


@pytest.mark.parametrize("B,KVH,G,S,D,causal,window", CASES, ids=IDS)
def test_ref_matches_jax_oracle(B, KVH, G, S, D, causal, window):
    q, k, v = _hsd(*_inputs(B, KVH, G, S, D))
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window)
    got = attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                        causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,KVH,G,S,D,causal,window",
                         [c for c in CASES if c[3] % 8 == 0],
                         ids=[i for c, i in zip(CASES, IDS) if c[3] % 8 == 0])
def test_cpu_wrapper_matches_pallas_interpret(B, KVH, G, S, D, causal,
                                              window):
    """The Pallas kernel itself (interpret mode, bq = bk = 8) against the
    port's kernel wrapper on CPU tensors."""
    q, k, v = _hsd(*_inputs(B, KVH, G, S, D, seed=1))
    want = jax_flash_hsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, bq=8, bk=8)
    got = flash_attention_hsd(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_valid_len_matches_pallas_interpret():
    """`valid_len` masks keys at or past it, as the Pallas kernel does for
    the zero-padded tail of a non-causal input."""
    q, k, v = _hsd(*_inputs(1, 2, 2, 16, 16, seed=2))
    want = jax_flash_hsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=False, bq=8, bk=8, valid_len=11)
    got = flash_attention_hsd(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=False, valid_len=11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,KVH,G,S,D,causal,window", CASES, ids=IDS)
def test_ops_matches_jax_padding_wrapper(B, KVH, G, S, D, causal, window):
    """JAX's (B,S,KVH,G,D) wrapper pads S to bq = 8 and masks the tail;
    the port masks inside the kernel and pads nothing."""
    qg, k, v = _inputs(B, KVH, G, S, D, seed=3)
    want = jax_flash(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, bq=8, bk=8)
    got = flash_attention(torch.tensor(qg), torch.tensor(k),
                          torch.tensor(v), causal=causal, window=window)
    assert got.shape == (B, S, KVH, G, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("B,KVH,G,S,D,causal,window", CASES, ids=IDS)
def test_dispatcher_matches_jax(B, KVH, G, S, D, causal, window,
                                use_kernel):
    qg, k, v = _inputs(B, KVH, G, S, D, seed=4)
    want = jax_attention(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, use_kernel=use_kernel)
    got = attention(torch.tensor(qg), torch.tensor(k), torch.tensor(v),
                    causal=causal, window=window, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# B, KVH, G, S, D, causal, window: spans past 32 keys, which the card runs
# through flash_fwd_f32 (the short-span kernels stop at 32): one key past
# them, ragged S against its 32- and 64-key tiles, G up to 8 (paligemma's
# one kv head), every head dim, a window across a tile, non-causal
LONG_CASES = [
    (2, 2, 3, 33, 64, True, 0),
    (1, 1, 8, 130, 256, True, 0),
    (2, 1, 4, 65, 32, True, 0),
    (1, 2, 5, 96, 128, True, 40),
    (1, 2, 2, 70, 32, False, 0),
    (1, 1, 3, 100, 64, True, 7),
]
LONG_IDS = [f"B{c[0]}-KVH{c[1]}-G{c[2]}-S{c[3]}-D{c[4]}-c{int(c[5])}"
            f"-w{c[6]}" for c in LONG_CASES]


@pytest.mark.parametrize("B,KVH,G,S,D,causal,window", LONG_CASES,
                         ids=LONG_IDS)
def test_long_span_matches_pallas_interpret(B, KVH, G, S, D, causal,
                                            window):
    """Past 32 keys: the model-layout entry against the Pallas kernel in
    interpret mode behind JAX's padding wrapper (bq = bk = 32)."""
    qg, k, v = _inputs(B, KVH, G, S, D, seed=5)
    want = jax_flash(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, bq=32, bk=32)
    got = flash_attention(torch.tensor(qg), torch.tensor(k),
                          torch.tensor(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("B,KVH,G,S,D,causal,window", LONG_CASES,
                         ids=LONG_IDS)
def test_long_span_dispatcher_matches_jax(B, KVH, G, S, D, causal, window,
                                          use_kernel):
    qg, k, v = _inputs(B, KVH, G, S, D, seed=6)
    want = jax_attention(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, use_kernel=use_kernel)
    got = attention(torch.tensor(qg), torch.tensor(k), torch.tensor(v),
                    causal=causal, window=window, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window,valid_len", [
    (False, 0, 45), (True, 0, 40), (True, 20, 50)])
def test_long_span_valid_len_matches_pallas_interpret(causal, window,
                                                      valid_len):
    """`valid_len` past 32 keys (alone, under the causal mask and with a
    window), against the Pallas kernel in interpret mode (bq = bk = 32)."""
    q, k, v = _hsd(*_inputs(1, 2, 4, 64, 64, seed=7))
    want = jax_flash_hsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, bq=32, bk=32,
                         valid_len=valid_len)
    got = flash_attention_hsd(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal, window=window,
                              valid_len=valid_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
