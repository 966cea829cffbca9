"""The port's V-trace seam (repro_torch.kernels.vtrace and core/vtrace.py)
against the JAX package on the CPU: `vtrace` against the JAX kernel (the
Pallas kernel in interpret mode) and `vtrace_ref`, with importance ratios
clipped from above (log ρ > 0) and below the clip, `epsilon_correction`,
and outputs that carry no gradient.

Inputs are made with numpy from a seed and fed to both frameworks;
values are held to f32 atol = rtol = 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.vtrace import epsilon_correction as jax_eps
from repro.kernels.vtrace.ops import vtrace as jax_vtrace_k
from repro.kernels.vtrace.ref import vtrace_ref as jax_vtrace_ref
from repro_torch.core import vtrace as seam
from repro_torch.kernels.vtrace import ops
from repro_torch.kernels.vtrace.kernel import vtrace_tb

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(T, B, seed=0):
    rng = np.random.default_rng(seed)
    log_rhos = (rng.standard_normal((T, B)) * 0.7).astype(np.float32)
    log_rhos[0] = 0.5            # rho = 1.65 > 1: clipped
    dones = rng.random((T, B)) < 0.1
    discounts = (0.99 * (1.0 - dones)).astype(np.float32)
    rewards = rng.standard_normal((T, B)).astype(np.float32)
    values = rng.standard_normal((T, B)).astype(np.float32)
    boot = rng.standard_normal((B,)).astype(np.float32)
    return log_rhos, discounts, rewards, values, boot


@pytest.mark.parametrize("T,B", [(1, 3), (8, 5), (33, 130)])
@pytest.mark.parametrize("clip_rho,clip_c", [(1.0, 1.0), (2.0, 0.5)])
def test_vtrace_matches_jax(T, B, clip_rho, clip_c):
    args = _inputs(T, B)
    k_vs, k_adv = jax_vtrace_k(*args, clip_rho=clip_rho, clip_c=clip_c)
    r_vs, r_adv = jax_vtrace_ref(*map(jnp.asarray, args),
                                 clip_rho=clip_rho, clip_c=clip_c)
    targs = [torch.tensor(a) for a in args]
    for vs, adv in (
            seam.vtrace(*targs, clip_rho, clip_c, use_kernel=True),
            seam.vtrace(*targs, clip_rho, clip_c, use_kernel=False),
            ops.vtrace(*targs, clip_rho=clip_rho, clip_c=clip_c)):
        for got, want in ((vs, k_vs), (adv, k_adv), (vs, r_vs),
                          (adv, r_adv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_vtrace_outputs_carry_no_gradient(use_kernel):
    """Both outputs are targets: detached even when every input requires
    grad (ref.py:31, ops.py:24-25 of the reference)."""
    targs = [torch.tensor(a, requires_grad=True) for a in _inputs(6, 4)]
    vs, adv = seam.vtrace(*targs, use_kernel=use_kernel)
    assert not vs.requires_grad and not adv.requires_grad
    assert vs.grad_fn is None and adv.grad_fn is None


def test_epsilon_correction_matches_jax():
    logp = np.array([-40.0, -10.0, -1.0, -1e-3, 0.0], np.float32)
    np.testing.assert_allclose(
        seam.epsilon_correction(torch.tensor(logp)).numpy(),
        np.asarray(jax_eps(jnp.asarray(logp))), **TOL)


def test_cpu_wrapper_launches_nothing():
    before = vtrace_tb.launches
    vtrace_tb(*[torch.tensor(a) for a in _inputs(4, 3)])
    assert vtrace_tb.launches == before
