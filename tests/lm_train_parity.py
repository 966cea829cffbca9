"""Shared pieces of tests/test_torch_lm_train.py and
tests/test_torch_lm_train_moe.py: the port's `LanguageModel.loss` and its
gradient against `jax.value_and_grad(model.loss, has_aux=True)` of the
reference on the same params (the reference's seed-0 init, carried
across by `params_from_jax`) and the same tokens (B, S+1) = (2, 17) from
numpy, with the reference's stub frontends (0.02 everywhere).

Each JAX model, its params and its jitted gradient are made once per
test process (`functools.lru_cache`), as tests/test_torch_lm_serve.py
does; with `--dist loadfile` each of the two files builds its own.

Tolerance (f32): the loss, ce and aux within rtol 2e-5; every gradient
leaf within rtol 2e-4 and atol 1e-5 x max|g_ref| of the leaf (the same
sums in another order); a leaf the loss does not reach is zero in both.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build_model
from repro.models.model import ModelOpts as JaxOpts
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.core.agent import value_and_grad
from repro_torch.launch.serve import stub_frontend
from repro_torch.models.model import ModelOpts, build_model

B, S = 2, 17


@pytest.fixture(autouse=True)
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    """The reference's seed-0 params of the reduced arch (f32 leaves
    whatever the compute dtype)."""
    jm = jax_build_model(arch, JaxOpts(remat=False), reduced=True)
    return jm.init(jax.random.PRNGKey(0))


def port_params(arch):
    """`jax_params(arch)` as the port's flat f32 params (a fresh copy)."""
    return params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                  jax_params(arch)))


def batches(cfg, seed=0):
    """The same batch for both packages: tokens (B, S) + 1 from numpy
    and the stub frontend of a model with one."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
    tb = {"tokens": torch.tensor(toks.astype(np.int32))}
    jb = {"tokens": jnp.asarray(toks.astype(np.int32))}
    fe = stub_frontend(cfg, B, "cpu")
    if fe is not None:
        tb["frontend"] = fe
        jb["frontend"] = jnp.asarray(fe.numpy())
    return tb, jb


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(arch, dtype="float32", remat=False):
    """((loss, ce, aux) as floats, the gradient as the port keys it in
    f32, the gradient as the reference's tree) of the reference's jitted
    value_and_grad, computed once."""
    jm = jax_build_model(arch, JaxOpts(dtype=dtype, remat=remat),
                         reduced=True)
    (loss, aux), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax_params(arch), batches(jm.cfg)[1])
    return ((float(loss), float(aux["ce"]), float(aux["aux"])),
            params_from_jax(jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), grads)), grads)


def port_value_and_grad(arch, dtype="float32", remat=False, params=None):
    """(model, (loss, {"ce", "aux"}), grads) of the port's loss on
    `params` (default `port_params(arch)`)."""
    tm = build_model(arch, ModelOpts(dtype=dtype, remat=remat),
                     reduced=True)
    params = port_params(arch) if params is None else params
    out, grads = value_and_grad(tm.loss, params, batches(tm.cfg)[0],
                                has_aux=True)
    return tm, out, grads


def assert_loss_close(out, want, rtol=2e-5):
    loss, metrics = out
    got = tuple(float(x.detach()) for x in (loss, metrics["ce"],
                                            metrics["aux"]))
    assert got == pytest.approx(want, rel=rtol, abs=1e-12), (got, want)


def assert_grads_close(grads, want, rel_to_max=1e-5, rtol=2e-4):
    """Leaf for leaf: the same keys, every leaf within `rtol` and
    `rel_to_max` x max|leaf of want|."""
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            grads[k].float().numpy(), w, rtol=rtol,
            atol=rel_to_max * float(np.abs(w).max()), err_msg=k)


def check_loss_and_grad(arch):
    """The f32 loss and every gradient leaf against the reference's."""
    want_loss, want_grads, _ = jax_value_and_grad(arch)
    _, out, grads = port_value_and_grad(arch)
    assert_loss_close(out, want_loss)
    assert_grads_close(grads, want_grads)


def check_remat(arch):
    """The port with remat is bitwise itself without (loss and grads:
    the recompute runs the same ops), recomputes each stack block in the
    backward (stack/0/t0 entered twice), and matches the
    reference's remat=True within the f32 tolerance."""
    _, out0, g0 = port_value_and_grad(arch, remat=False)
    tm, out1, g1 = port_value_and_grad(arch, remat=True)
    assert torch.equal(out0[0], out1[0])
    assert all(torch.equal(out0[1][k], out1[1][k]) for k in ("ce", "aux"))
    assert sorted(g0) == sorted(g1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    calls = []
    tm.stack[0]["t0"].register_forward_pre_hook(lambda *a: calls.append(1))
    value_and_grad(tm.loss, port_params(arch), batches(tm.cfg)[0],
                   has_aux=True)
    assert len(calls) == 2
    want_loss, want_grads, _ = jax_value_and_grad(arch, remat=True)
    assert_loss_close(out1, want_loss)
    assert_grads_close(g1, want_grads)


def check_bf16(arch, loss_rtol=2.0 ** -10, grad_rel_to_max=2.0 ** -5):
    """bf16 compute on f32 master weights against the reference's bf16
    model on its f32 params: the master leaves and their gradients stay
    f32, the loss within `loss_rtol`, every gradient leaf within
    `grad_rel_to_max` x max|g_ref| (the two packages round in different
    orders)."""
    params = port_params(arch)
    assert all(v.dtype == torch.float32 for v in params.values())
    _, out, grads = port_value_and_grad(arch, "bfloat16", params=params)
    assert all(v.dtype == torch.float32 for v in params.values())
    assert all(g.dtype == torch.float32 for g in grads.values())
    want_loss, want_grads, _ = jax_value_and_grad(arch, "bfloat16")
    assert_loss_close(out, want_loss, rtol=loss_rtol)
    assert_grads_close(grads, want_grads, rel_to_max=grad_rel_to_max,
                       rtol=0.0)


def check_optimizer_step(arch, steps=200, lr=3e-4):
    """One step of the launcher's optimizer, clip_by_global_norm(adamw(
    cosine_schedule(lr, steps, warmup=steps // 20)), 1.0), on the
    reference's params and gradient: the port's `apply_leafwise` (what
    launch/train.py runs) against the reference's `apply`, params and
    moments within 1e-6; and bitwise the port's own `apply` (groups of
    at most 4096 elements: many groups, the larger leaves alone)."""
    from repro import optim as jax_optim
    from repro_torch import optim
    opts = [m.clip_by_global_norm(m.adamw(m.cosine_schedule(
        lr, steps, warmup=steps // 20)), 1.0) for m in (jax_optim, optim)]
    jopt, topt = opts
    _, want_grads, jgrads = jax_value_and_grad(arch)
    jp, js = jax.jit(jopt.apply)(jax_params(arch),
                                 jopt.init(jax_params(arch)), jgrads)
    params = port_params(arch)
    ref_p, ref_s = topt.apply(params, topt.init(params), want_grads)
    state = topt.init(params)
    topt.apply_leafwise(params, state, dict(want_grads), group_numel=4096)
    assert int(state["step"]) == int(js["step"]) == 1
    for got, ref, want in ((params, ref_p, jp), (state["m"], ref_s["m"],
                                                js["m"]),
                           (state["v"], ref_s["v"], js["v"])):
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, want))
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], ref[k]), k
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)

