"""The port's MoE FFN against the JAX package on the CPU, on
deepseek-moe-16b.reduced() (4 experts, top-2, 1 shared expert, d 128):
`apply_moe` output and aux loss against JAX's with `use_kernels=True`
(the Pallas grouped matmul in interpret mode), at the default capacity
factor (tokens dropped: the port must drop the same ones) and at 16.0
(nothing dropped) against both packages' dense oracles; and router ties,
which must go to the lower expert index as in `jax.lax.top_k`.

Tolerance: f32 rtol = 2e-5 and atol = 2e-6 x max|reference output|:
the same math summed in another order. The reference's fan-in init takes
shape[0] = E = 4 as the fan-in of the (E, d, f) expert weights, so the
expert outputs reach ~10^2 at unit-RMS inputs and f32 rounding scales
with them. The routing decisions themselves are exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import moe as jmoe
from repro_torch.configs.base import get_config
from repro_torch.kernels.gmm.kernel import gmm_ecd
from repro_torch.models import moe as tmoe



def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5,
                               atol=2e-6 * float(np.abs(want).max()))


def _cfgs(capacity_factor=None):
    j = jax_get_config("deepseek-moe-16b").reduced()
    t = get_config("deepseek-moe-16b").reduced()
    if capacity_factor is not None:
        j = dataclasses.replace(j, moe=dataclasses.replace(
            j.moe, capacity_factor=capacity_factor))
        t = dataclasses.replace(t, moe=dataclasses.replace(
            t.moe, capacity_factor=capacity_factor))
    return j, t


def _params(jcfg, seed=0):
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed))
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), jp)
    return jp, tp


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _group_sizes(cfg, tp, x):
    _, _, topi = tmoe._route(cfg, tp, torch.tensor(x).reshape(-1, x.shape[-1]))
    return torch.bincount(topi.reshape(-1), minlength=cfg.moe.n_experts)


def test_reduced_config_matches_jax():
    j, t = _cfgs()
    assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
    assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.head_dim) == \
        (j.n_layers, j.d_model, j.n_heads, j.n_kv_heads, j.head_dim)
    full_j, full_t = (jax_get_config("deepseek-moe-16b"),
                      get_config("deepseek-moe-16b"))
    assert full_t.param_count() == full_j.param_count() == 16_375_611_392


@pytest.mark.parametrize("use_kernels", [True, False])
def test_apply_moe_drops_the_same_tokens_as_jax(use_kernels):
    """Default capacity factor 1.25 at T = 64: C = 40 slots per expert.
    The inputs lean towards router column 0, so expert 0 gets 55 of the
    128 assignments and 15 are dropped, in sorted order."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    lean = np.asarray(jp["router"])[:, 0]
    x = _x((4, 16, tcfg.d_model)) + lean / np.linalg.norm(lean)
    T = 64
    C = int(max(8, round(T * 2 / 4 * 1.25)))
    assert C == 40 and int(_group_sizes(tcfg, tp, x).max()) == 55
    want, waux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x), use_kernels=True)
    gmm_ecd.launches = 0
    got, aux = tmoe.apply_moe(tcfg, tp, torch.tensor(x),
                              use_kernels=use_kernels)
    assert gmm_ecd.launches == 0  # CPU tensors: the plain version
    assert got.shape == x.shape and aux.dtype == torch.float32
    _close(got.numpy(), want)
    _close(aux.item(), float(waux))
    # and it differs from the undropped oracle: tokens really were dropped
    oracle = tmoe.apply_moe_dense_oracle(tcfg, tp, torch.tensor(x))
    assert float((oracle - got).abs().max()) > 1e-3


def test_dispatch_passes_each_experts_routed_rows_to_the_gmm(monkeypatch):
    """The three grouped matmuls of a dispatch get each expert's routed
    count (the load before capacity, which the kernel clamps to C) as
    `rows`, a keyword, with x and w positional (bench/trace.py wraps
    `_gmm` and reads args[0] and args[1]); x's rows past the count are
    zero, so the kernel may skip them."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    lean = np.asarray(jp["router"])[:, 0]
    x = _x((4, 16, tcfg.d_model)) + lean / np.linalg.norm(lean)
    seen, gmm = [], tmoe._gmm
    monkeypatch.setattr(tmoe, "_gmm", lambda *a, **k: (
        seen.append((a, k)), gmm(*a, **k))[1])
    want, _ = jmoe.apply_moe(jcfg, jp, jnp.asarray(x), use_kernels=True)
    got, _ = tmoe.apply_moe(tcfg, tp, torch.tensor(x), use_kernels=True)
    _close(got.numpy(), want)
    load = _group_sizes(tcfg, tp, x)
    C = 40
    assert len(seen) == 3 and int(load.max()) == 55
    for (xe, w, use_kernels), kw in seen:
        assert use_kernels is True and set(kw) == {"rows"}
        rows = kw["rows"]
        assert rows.dtype == torch.int64 and rows.is_contiguous()
        assert torch.equal(rows, load)
        past = torch.arange(C)[None, :] >= rows.clamp_max(C)[:, None]
        assert xe.shape[:2] == (4, C) and not xe[past].any()
        assert xe[~past].abs().sum(-1).min() > 0


def test_apply_moe_matches_dense_oracles_without_drops():
    jcfg, tcfg = _cfgs(capacity_factor=16.0)
    jp, tp = _params(jcfg, seed=2)
    x = _x((2, 24, tcfg.d_model), seed=3)
    got, aux = tmoe.apply_moe(tcfg, tp, torch.tensor(x), use_kernels=True)
    want, waux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x), use_kernels=True)
    _close(got.numpy(), want)
    _close(aux.item(), float(waux))
    toracle = tmoe.apply_moe_dense_oracle(tcfg, tp, torch.tensor(x))
    joracle = jmoe.apply_moe_dense_oracle(jcfg, jp, jnp.asarray(x))
    _close(toracle.numpy(), joracle)
    _close(got.numpy(), toracle.numpy())


def test_router_ties_go_to_the_lower_expert():
    """Experts 1, 2 and 3 get identical router columns, so every token
    ties among them: top-2 must pick by lower index, as lax.top_k does."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.tensor(router))
    x = _x((2, 8, tcfg.d_model), seed=5)
    xt = torch.tensor(x).reshape(16, -1)
    _, topv, topi = tmoe._route(tcfg, tp, xt)
    logits = jnp.asarray(x).reshape(16, -1) @ jnp.asarray(router)
    jv, ji = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 2)
    assert np.array_equal(topi.numpy(), np.asarray(ji))
    assert set(np.unique(topi.numpy())) <= {0, 1, 2}
    assert not (topi == 3).any() and not (topi[:, 1] == 2).all()
    got, aux = tmoe.apply_moe(tcfg, tp, torch.tensor(x), use_kernels=True)
    want, waux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x), use_kernels=True)
    _close(got.numpy(), want)
    _close(aux.item(), float(waux))


def test_local_dispatch_is_refused_by_name():
    """Row-local dispatch (`local_dispatch=True`) runs, as the reference's
    does: each row dispatched on its own capacity (C = 8 for 12 tokens,
    so the leaning rows drop tokens), on the model's einsum whatever
    `use_kernels`, aux the mean over the rows."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=6)
    lean = np.asarray(jp["router"])[:, 0]
    x = _x((3, 12, tcfg.d_model), seed=7) + lean / np.linalg.norm(lean)
    want, waux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x),
                                local_dispatch=True)
    gmm_ecd.launches = 0
    got, aux = tmoe.apply_moe(tcfg, tp, torch.tensor(x), use_kernels=True,
                              local_dispatch=True)
    assert gmm_ecd.launches == 0 and got.shape == x.shape
    _close(got.numpy(), want)
    _close(aux.item(), float(waux))
