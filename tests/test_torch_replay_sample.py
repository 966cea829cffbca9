"""The port's fused prioritized draw (repro_torch.kernels.replay_sample and
the core/replay_sample.py seam) on the CPU against the JAX package: the
plain version against `prioritized_sample_ref` and against the Pallas
kernel in interpret mode (`repro.kernels.replay_sample.ops`, as
tests/test_kernels.py runs it), on the same priorities and the same
Gumbel vector from JAX. Indices exact, weights within rtol = atol = 1e-5
(tests/test_kernels.py's tolerance). Ties are forced in both inputs
(`prio[1::7] = prio[0]`, `gumbel[1::7] = gumbel[0]`), so a draw that
broke ties in any order but the lower index first would fail."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.replay_sample.ops import prioritized_sample as jax_kernel
from repro.kernels.replay_sample.ref import prioritized_sample_ref as jax_ref
from repro_torch.core.replay_sample import fused_prioritized_sample
from repro_torch.kernels.replay_sample import ops
from repro_torch.kernels.replay_sample.kernel import prioritized_sample_c
from repro_torch.kernels.replay_sample.ref import (prioritized_sample_ref,
                                                   prioritized_weights_ref)

TOL = dict(atol=1e-5, rtol=1e-5)
# (C, size, n): tests/test_kernels.py's five cases, then an empty buffer
CASES = [(512, 300, 64), (2048, 2048, 128), (256, 17, 16), (131, 100, 1),
         (64, 10, 32), (64, 0, 16)]


def _inputs(C, ties, seed=0):
    """Priorities from a numpy seed and JAX's Gumbel vector, as float32
    numpy arrays."""
    prio = (np.abs(np.random.default_rng(seed).standard_normal(C))
            + 0.01).astype(np.float32)
    gumbel = np.array(jax.random.gumbel(jax.random.PRNGKey(seed), (C,)))
    if ties:
        prio[1::7] = prio[0]
        gumbel[1::7] = gumbel[0]
    return prio, gumbel


def _port(prio, size, gumbel, n, **kw):
    idx, w = prioritized_sample_ref(torch.tensor(prio),
                                    torch.tensor(size, dtype=torch.int32),
                                    torch.tensor(gumbel), n, **kw)
    return idx.numpy(), w.numpy()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("C,size,n", CASES)
def test_plain_draw_matches_jax_ref_and_kernel(C, size, n, ties):
    prio, gumbel = _inputs(C, ties, seed=C + size)
    idx, w = _port(prio, size, gumbel, n)
    assert idx.dtype == np.int32 and w.dtype == np.float32
    for j_idx, j_w in (jax_ref(jnp.asarray(prio), size, jnp.asarray(gumbel),
                               n),
                       jax_kernel(jnp.asarray(prio), jnp.int32(size),
                                  jnp.asarray(gumbel), n)):
        np.testing.assert_array_equal(idx, np.asarray(j_idx))
        np.testing.assert_allclose(w, np.asarray(j_w), **TOL)
    assert (idx < max(size, 1)).all(), "never returns an unfilled slot"


def test_ties_go_to_the_lower_index():
    """Equal scores keep index order, as lax.top_k: slots 0, 1, 8, 15, ...
    carry one score, the largest; the draw lists them in index order."""
    C, n = 64, 12
    prio = np.full(C, 0.5, np.float32)
    gumbel = np.zeros(C, np.float32)
    prio[1::7] = prio[0] = 3.0
    idx, _ = _port(prio, C, gumbel, n)
    tied = [0] + list(range(1, C, 7))
    np.testing.assert_array_equal(idx[:len(tied)], tied)
    np.testing.assert_array_equal(idx[len(tied):],
                                  [s for s in range(C) if s not in tied][
                                      :n - len(tied)])


@pytest.mark.parametrize("size", [0, 1, 5])
def test_surplus_positions_repeat_the_top_draw(size):
    """n > size: the first max(size, 1) positions hold every filled slot;
    the rest repeat idx[0] and its real weight."""
    prio, gumbel = _inputs(32, ties=False, seed=size)
    idx, w = _port(prio, size, gumbel, 16)
    nvalid = max(size, 1)
    assert sorted(idx[:nvalid]) == list(range(nvalid))
    assert (idx[nvalid:] == idx[0]).all() and (w[nvalid:] == w[0]).all()
    assert np.isfinite(w).all() and w.max() == pytest.approx(1.0)


def test_without_replacement_and_weights_normalized():
    prio, gumbel = _inputs(512, ties=False, seed=3)
    idx, w = _port(prio, 400, gumbel, 64)
    assert len(set(idx.tolist())) == 64
    assert ((w > 0) & (w <= 1.0 + 1e-6)).all()
    assert w.max() == pytest.approx(1.0)


def test_weights_half_is_the_draws():
    prio, gumbel = _inputs(256, ties=True, seed=4)
    idx, w = prioritized_sample_ref(torch.tensor(prio), torch.tensor(200),
                                    torch.tensor(gumbel), 32)
    assert torch.equal(prioritized_weights_ref(torch.tensor(prio),
                                               torch.tensor(200), idx), w)


def test_seam_and_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the seam (either flag), the ops layer (with a Python
    int size) and the kernel binding all give the plain draw; none counts
    a kernel launch."""
    prio, gumbel = _inputs(300, ties=True, seed=5)
    p, g = torch.tensor(prio), torch.tensor(gumbel)
    size = torch.tensor(250, dtype=torch.int32)
    want = prioritized_sample_ref(p, size, g, 24, alpha=0.7, beta=0.5)
    before = prioritized_sample_c.launches
    for got in (fused_prioritized_sample(p, size, g, 24, 0.7, 0.5,
                                         use_kernel=True),
                fused_prioritized_sample(p, size, g, 24, 0.7, 0.5),
                ops.prioritized_sample(p, 250, g, 24, 0.7, 0.5),
                prioritized_sample_c(p, g, size.reshape(1), 24, 0.7, 0.5)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert prioritized_sample_c.launches == before
