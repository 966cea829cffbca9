"""The port's discounted-return seam (repro_torch.kernels.advantages and
core/advantages.py) against the JAX package on the CPU: `discounted_return`,
`gae` and `nstep_return` against the JAX ops (the Pallas kernel in
interpret mode) and refs, and the plain adjoint against `jax.vjp` of the
JAX ref and torch autograd through the plain forward.

Inputs are made with numpy from a seed and fed to both frameworks.
Values are held to f32 atol = rtol = 1e-5 (the same scan, the same f32
operations; the bound the JAX kernel tests use)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.advantages import ops as jax_ops
from repro.kernels.advantages.ref import (discounted_return_ref as jax_dr,
                                          gae_ref as jax_gae,
                                          nstep_return_ref as jax_nstep)
from repro_torch.core import advantages as seam
from repro_torch.kernels.advantages import ops
from repro_torch.kernels.advantages.kernel import (
    DiscountedReturn, discounted_return_adjoint_tb, discounted_return_tb)
from repro_torch.kernels.advantages.ref import (
    discounted_return_adjoint_ref, discounted_return_ref)

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [(1, 3), (8, 5), (33, 130)]


def _inputs(T, B, seed=0):
    """rewards, values, dones (done at t = 0 and t = T-1 in some columns
    plus random ones), bootstrap, and a coefficient in [0, 1)."""
    rng = np.random.default_rng(seed)
    rew = rng.standard_normal((T, B)).astype(np.float32)
    val = rng.standard_normal((T, B)).astype(np.float32)
    dones = rng.random((T, B)) < 0.1
    dones[0, ::2] = True
    dones[T - 1, 1::3] = True
    boot = rng.standard_normal((B,)).astype(np.float32)
    coef = rng.random((T, B)).astype(np.float32)
    return rew, val, dones, boot, coef


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("T,B", SHAPES)
def test_discounted_return_matches_jax(T, B):
    rew, _, _, boot, coef = _inputs(T, B)
    want_k = np.asarray(jax_ops.discounted_return(rew, coef, boot))
    want_r = np.asarray(jax_dr(jnp.asarray(rew), jnp.asarray(coef),
                               jnp.asarray(boot)))
    base, c, init = _t(rew, coef, boot)
    for got in (ops.discounted_return(base, c, init),
                seam.discounted_return(base, c, init, use_kernel=True),
                seam.discounted_return(base, c, init),
                discounted_return_tb(base, c, init)):
        np.testing.assert_allclose(got.numpy(), want_k, **TOL)
        np.testing.assert_allclose(got.numpy(), want_r, **TOL)


@pytest.mark.parametrize("T,B", SHAPES)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_gae_matches_jax(T, B, use_kernel):
    rew, val, dones, boot, _ = _inputs(T, B, seed=1)
    ka, kr = jax_ops.gae(rew, val, dones, boot, 0.99, 0.95)
    ra, rr = jax_gae(jnp.asarray(rew), jnp.asarray(val),
                     jnp.asarray(dones), jnp.asarray(boot), 0.99, 0.95)
    r, v, d, b = _t(rew, val, dones, boot)
    adv, ret = seam.gae(r, v, d, b, 0.99, 0.95, use_kernel=use_kernel)
    for got, want in ((adv, ka), (ret, kr), (adv, ra), (ret, rr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("T,B", SHAPES)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_nstep_return_matches_jax(T, B, use_kernel):
    rew, _, dones, boot, _ = _inputs(T, B, seed=2)
    want_k = jax_ops.nstep_return(rew, dones, boot, 0.99)
    want_r = jax_nstep(jnp.asarray(rew), jnp.asarray(dones),
                       jnp.asarray(boot), 0.99)
    r, d, b = _t(rew, dones, boot)
    got = seam.nstep_return(r, d, b, 0.99, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_r), **TOL)


@pytest.mark.parametrize("T,B", SHAPES)
def test_adjoint_ref_matches_jax_vjp(T, B):
    """dbase, dcoef, dinit of the plain adjoint against jax.vjp of the
    JAX ref at the same cotangent."""
    rew, val, _, boot, coef = _inputs(T, B, seed=3)
    g = val  # any cotangent
    out, vjp = jax.vjp(jax_dr, jnp.asarray(rew), jnp.asarray(coef),
                       jnp.asarray(boot))
    want = vjp(jnp.asarray(g))
    gt, ct, ot, it = _t(g, coef, np.asarray(out), boot)
    got = discounted_return_adjoint_ref(gt, ct, ot, it)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("T,B", SHAPES)
def test_adjoint_ref_matches_torch_autograd(T, B):
    """The plain adjoint equals autograd through the plain forward, and
    `DiscountedReturn` (the kernel's autograd Function, here on its plain
    CPU versions) gives the same gradients."""
    rew, val, _, boot, coef = _inputs(T, B, seed=4)
    g = torch.tensor(val)
    leaves = [torch.tensor(a, requires_grad=True) for a in (rew, coef,
                                                              boot)]
    out = discounted_return_ref(*leaves)
    want = torch.autograd.grad(out, leaves, g)
    got = discounted_return_adjoint_ref(g, leaves[1].detach(),
                                        out.detach(), leaves[2].detach())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    leaves2 = [x.detach().clone().requires_grad_() for x in leaves]
    via_fn = torch.autograd.grad(DiscountedReturn.apply(*leaves2), leaves2,
                                 g)
    for a, b in zip(via_fn, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_function_asks_only_for_needed_gradients():
    """With only `init` requiring grad (A3C's case: the bootstrap value),
    backward returns None for base and coef, and the expanded (stride 0)
    gradient of a mean is taken as it comes."""
    rew, _, _, boot, coef = _inputs(6, 4, seed=5)
    init = torch.tensor(boot, requires_grad=True)
    out = DiscountedReturn.apply(torch.tensor(rew), torch.tensor(coef), init)
    out.mean().backward()
    ref_init = torch.tensor(boot, requires_grad=True)
    discounted_return_ref(torch.tensor(rew), torch.tensor(coef),
                          ref_init).mean().backward()
    np.testing.assert_allclose(init.grad.numpy(), ref_init.grad.numpy(),
                               **TOL)
    g = torch.ones(()).expand(6, 4)
    got = discounted_return_adjoint_tb(g, torch.tensor(coef), out.detach(),
                                       init.detach(),
                                       need=(False, False, True))
    assert got[0] is None and got[1] is None
    np.testing.assert_allclose(got[2].numpy() / 24, init.grad.numpy(), **TOL)


def test_cpu_wrappers_launch_nothing():
    """On the CPU the wrappers take the plain versions: no launch is
    counted."""
    before = (discounted_return_tb.launches,
              discounted_return_adjoint_tb.launches)
    rew, _, _, boot, coef = _inputs(4, 3)
    b = torch.tensor(boot, requires_grad=True)
    DiscountedReturn.apply(torch.tensor(rew), torch.tensor(coef),
                           b).sum().backward()
    assert (discounted_return_tb.launches,
            discounted_return_adjoint_tb.launches) == before
