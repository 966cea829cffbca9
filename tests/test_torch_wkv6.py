"""The port's chunked WKV against the JAX package on the CPU: the plain
version (`wkv6_ref`, y and the final state) against JAX's `wkv6_ref` and
against JAX's `ops.wkv6` (the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it), a carried initial state against JAX's
`wkv_chunked`, and the port's wrapper, which takes the plain version for
CPU tensors (no launch).

Tolerance: atol = 2e-4, rtol = 1e-3, the reference's own
(tests/test_kernels.py: the same f32 recurrence blocked or summed in
another order). Inputs come from numpy with a fixed seed, with a nonzero
u so the diagonal bonus term is exercised."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked
from repro_torch.kernels.wkv6 import ops
from repro_torch.kernels.wkv6.kernel import wkv6_btHN
from repro_torch.kernels.wkv6.ref import wkv6_ref

TOL = dict(atol=2e-4, rtol=1e-3)
# the reference's sweep (tests/test_kernels.py::test_wkv6_sweep); the
# last needs padding in the reference and masking here
SWEEP = [(2, 100, 3, 16, 32), (1, 64, 2, 64, 64), (1, 37, 1, 8, 16)]


def _inputs(B, T, H, N, seed=0, state=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(0.5 * rng.standard_normal((B, T, H, N))).astype(
        np.float32)
    u = (0.3 + 0.2 * rng.standard_normal((H, N))).astype(np.float32)
    out = [r, k, v, logw, u]
    if state:
        out.append((0.2 * rng.standard_normal((B, H, N, N))).astype(
            np.float32))
    return out


def _t(arrays):
    return [torch.tensor(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,T,H,N,chunk", SWEEP)
def test_wkv6_ref_matches_jax_ref_and_pallas_kernel(B, T, H, N, chunk):
    x = _inputs(B, T, H, N)
    y, S = wkv6_ref(*_t(x))
    assert y.shape == (B, T, H, N) and S.shape == (B, H, N, N)
    jy, jS = jax_wkv6_ref(*_j(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(
        jax_wkv6(*_j(x), chunk=chunk)), **TOL)


@pytest.mark.parametrize("B,T,H,N,chunk", SWEEP)
def test_wrapper_takes_the_plain_version_on_the_cpu(B, T, H, N, chunk):
    x = _inputs(B, T, H, N, seed=1)
    wkv6_btHN.launches = 0
    y, S = ops.wkv6(*_t(x), chunk)
    assert wkv6_btHN.launches == 0
    assert y.dtype == S.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(
        jax_wkv6(*_j(x), chunk=chunk)), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(
        jax_wkv6_ref(*_j(x))[1]), **TOL)


@pytest.mark.parametrize("B,T,H,N,chunk", [(2, 50, 2, 16, 16),
                                           (1, 37, 1, 8, 16)])
def test_carried_state_matches_jax_wkv_chunked(B, T, H, N, chunk):
    """A nonzero initial state (the model path's): y and the final S
    against the reference model's chunked WKV."""
    x = _inputs(B, T, H, N, seed=2, state=True)
    jy, jS = jax_wkv_chunked(*_j(x), chunk=chunk)
    for y, S in (wkv6_ref(*_t(x)), ops.wkv6(*_t(x[:5]), chunk, _t(x)[5])):
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(S.numpy(), np.asarray(jS), **TOL)


def test_in_place_writes_the_final_state_over_the_initial_one():
    x = _t(_inputs(2, 9, 3, 8, seed=3, state=True))
    want_y, want_S = wkv6_ref(*x)
    state = x[5].clone()
    y, S = ops.wkv6(*x[:5], 4, state)
    assert S is state
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(state, want_S, rtol=0, atol=0)
    zeros = torch.zeros_like(state)  # None: a new S from a zero state
    y0, S0 = ops.wkv6(*x[:5], 4, None)
    torch.testing.assert_close(y0, wkv6_ref(*x[:5], zeros)[0], rtol=0,
                               atol=0)
    torch.testing.assert_close(S0, wkv6_ref(*x[:5], zeros)[1], rtol=0,
                               atol=0)
    assert S0 is not state


def test_ops_casts_bf16_inputs_to_f32():
    """The time mix hands the WKV bf16 r, k, v under a bf16 model; the
    wrapper computes in f32 on the values as given (JAX's ops.wkv6 casts
    the same way)."""
    x = _inputs(1, 20, 2, 8, seed=4)
    xb = [torch.tensor(a).to(torch.bfloat16) for a in x[:3]]
    y, _ = ops.wkv6(*xb, *_t(x[3:]), 8)
    want = jax_wkv6(*[jnp.asarray(a.float().numpy()) for a in xb],
                    *_j(x[3:]), chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
