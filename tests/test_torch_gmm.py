"""The port's grouped matmul against the JAX package on the CPU: the plain
version (`gmm_ref`) against JAX's `gmm_ref` and against JAX's `ops.gmm`
(the Pallas kernel in interpret mode, as tests/test_kernels.py runs it),
and the port's wrapper, which takes the plain version for CPU tensors.
With each expert's count of rows that hold input (`rows`), both hold
JAX's `gmm` on x with the rows past the count zeroed; the rows there
hold NaN, so a read of them would show.

Tolerances: f32 atol = 3e-4, rtol = 1e-4 (tests/test_kernels.py's, the
same f32 products summed in another order over d <= 512); bf16 inputs,
bf16 outputs: atol = 0.2, rtol = 0.05 (tests/test_kernels.py's; both
round one f32 sum to bf16). Inputs come from numpy with a fixed seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gmm.ops import gmm as jax_gmm
from repro.kernels.gmm.ref import gmm_ref as jax_gmm_ref
from repro_torch.kernels.gmm.kernel import gmm_ecd
from repro_torch.kernels.gmm.ops import gmm
from repro_torch.kernels.gmm.ref import gmm_ref

F32 = dict(atol=3e-4, rtol=1e-4)
BF16 = dict(atol=0.2, rtol=0.05)


def _inputs(E, C, d, f, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, C, d)).astype(np.float32),
            rng.standard_normal((E, d, f)).astype(np.float32))


@pytest.mark.parametrize("E,C,d,f", [
    (4, 70, 96, 130),                  # padding on every axis
    (2, 128, 128, 128),                # exact tiles
    (8, 16, 512, 64),
    (3, 5, 40, 24),                    # C below any tile
    (4, 60, 96, 130),                  # f32 C-tile of 64 rows, ragged
    (2, 240, 64, 48),                  # f32 C-tiles of 64, the last ragged
])
def test_gmm_ref_matches_jax(E, C, d, f):
    x, w = _inputs(E, C, d, f)
    got = gmm_ref(torch.tensor(x), torch.tensor(w))
    assert got.dtype == torch.float32 and got.shape == (E, C, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_gmm_ref(jnp.asarray(x), jnp.asarray(w))), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_gmm(jnp.asarray(x), jnp.asarray(w))), **F32)


def test_gmm_wrapper_takes_the_plain_version_on_the_cpu():
    x, w = _inputs(4, 70, 96, 130, seed=1)
    gmm_ecd.launches = 0
    got = gmm(torch.tensor(x), torch.tensor(w))
    assert gmm_ecd.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_gmm(jnp.asarray(x), jnp.asarray(w))), **F32)


@pytest.mark.parametrize("E,C,d,f", [(4, 60, 96, 130), (2, 240, 64, 48)])
def test_gmm_f32_past_32_rows_matches_jax(E, C, d, f):
    """The f32 wrapper at C past 32 rows (deepseek's C = 60 at a 128-token
    prompt): the plain version on the CPU against JAX's kernel in
    interpret mode and its oracle."""
    x, w = _inputs(E, C, d, f, seed=3)
    gmm_ecd.launches = 0
    got = gmm(torch.tensor(x), torch.tensor(w))
    assert gmm_ecd.launches == 0
    assert got.dtype == torch.float32 and got.shape == (E, C, f)
    for want in (jax_gmm(jnp.asarray(x), jnp.asarray(w)),
                 jax_gmm_ref(jnp.asarray(x), jnp.asarray(w))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_gmm_bf16_matches_jax():
    """bf16 x, f32 w: the wrapper casts w to x's dtype, as JAX's ops.gmm
    does (tests/test_kernels.py::test_gmm_bf16)."""
    x, w = _inputs(2, 64, 64, 64, seed=2)
    xb = torch.tensor(x).to(torch.bfloat16)
    got = gmm(xb, torch.tensor(w))
    want = jax_gmm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jax_gmm_ref(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(w).astype(jnp.bfloat16)),
                   np.float32), **BF16)


# (E, C, d, f, rows): counts of 0, C, past C (clamped), negative
# (clamped to 0) and inside a 64-row tile
ROWS_CASES = [
    (4, 70, 96, 130, [0, 70, 71, 33]),
    (4, 202, 64, 48, [202, 64, 65, -1]),
    (2, 8, 40, 24, [3, 9]),
]


def _held_x(x, rows):
    """x with rows c >= rows[e] zeroed (the masked x), and x with NaN
    there (what the kernel must not read)."""
    held = np.arange(x.shape[1])[None, :] < np.asarray(rows)[:, None]
    return (np.where(held[..., None], x, 0).astype(np.float32),
            np.where(held[..., None], x, np.nan).astype(np.float32))


@pytest.mark.parametrize("E,C,d,f,rows", ROWS_CASES)
def test_gmm_rows_match_jax_on_the_masked_x(E, C, d, f, rows):
    x, w = _inputs(E, C, d, f, seed=4)
    masked, poisoned = _held_x(x, rows)
    want = np.asarray(jax_gmm(jnp.asarray(masked), jnp.asarray(w)))
    r = torch.tensor(rows, dtype=torch.int64)
    past = np.arange(C)[None, :] >= np.asarray(rows)[:, None]
    gmm_ecd.launches = 0
    for got in (gmm_ref(torch.tensor(poisoned), torch.tensor(w), r),
                gmm(torch.tensor(poisoned), torch.tensor(w), r)):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, **F32)
        assert (got.numpy()[past] == 0).all()
    assert gmm_ecd.launches == 0


@pytest.mark.parametrize("bad", ["int32", "length", "strided", "list"])
def test_gmm_refuses_rows_of_another_form(bad):
    """rows must be a contiguous int64 (E,) tensor on x's device: no
    silent cast (the card tests add a CPU-resident rows beside card x)."""
    x, w = (torch.tensor(a) for a in _inputs(4, 16, 8, 8))
    rows = {"int32": torch.full((4,), 3, dtype=torch.int32),
            "length": torch.full((5,), 3, dtype=torch.int64),
            "strided": torch.full((8,), 3, dtype=torch.int64)[::2],
            "list": [3, 3, 3, 3]}[bad]
    with pytest.raises(ValueError, match="rows must be"):
        gmm_ecd(x, w, rows)
