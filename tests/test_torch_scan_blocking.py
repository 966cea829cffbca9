"""The Hopper discounted-return kernels' blocking on the CPU: a plain
torch transcription of their parallel affine scans (each step a map
x -> b + c*x): up to T = 32 (`short_scan`, `short_adjoint`) each of 8
warps composing the maps of its 4 rows and then the maps of the warps
before or after it; above (`scan_blocking`, `adjoint_blocking`) each
lane of a warp composing the maps of its K rows, a 5-level shuffle tree
composing them across 32 lanes, passes of 32K rows joined by the carry
between them, as the kernels take it and, with one row a lane, at every
T (several passes from T = 33); against JAX's `discounted_return_ref`
and, for the adjoint, `jax.vjp` of it, at ragged T and B, with coef in
[0, 0.99) and with coef = 0 (dones).
Beside it, the host side the CPU reaches: the packed arguments of both
entries (`ScanFwdParams`, `ScanAdjParams`), field by field.

Inputs come from numpy with a fixed seed. Tolerance: atol = rtol = 1e-5,
the bound of the JAX kernel tests (the same f32 recurrence composed in
another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.advantages.ref import discounted_return_ref as jax_dr
from repro_torch.kernels.advantages import kernel as sk

TOL = dict(atol=1e-5, rtol=1e-5)
LANES = 32


def choose_k(T):
    """Rows a lane takes per pass of the tiled scans (advantages.cu
    `choose_k`, T > 32)."""
    return 4 if T <= 128 else 16


SHORT_T, WARPS = 32, 8


def short_scan(base, coef, init):
    """T <= 32 as discounted_return_fwd_short takes it: warp w composes
    the maps of rows 4w..4w+3, composes the maps of the warps after it
    onto init, and plays its rows."""
    T, B = base.shape
    R = SHORT_T // WARPS
    maps = []
    for w in range(WARPS):
        C, Bv = torch.ones(B), torch.zeros(B)
        for t in reversed(range(w * R, min(w * R + R, T))):
            Bv, C = base[t] + coef[t] * Bv, coef[t] * C
        maps.append((C, Bv))
    out = torch.empty_like(base)
    for w in range(WARPS):
        x = init
        for u in reversed(range(w + 1, WARPS)):
            x = maps[u][1] + maps[u][0] * x
        for t in reversed(range(w * R, min(w * R + R, T))):
            x = base[t] + coef[t] * x
            out[t] = x
    return out


def short_adjoint(g, coef, out, init):
    """T <= 32 as discounted_return_adj_short takes it."""
    T, B = g.shape
    R = SHORT_T // WARPS
    cp = torch.cat([torch.zeros(1, B), coef[:-1]])  # coef_{t-1}, 0 at t = 0
    maps = []
    for w in range(WARPS):
        C, Bv = torch.ones(B), torch.zeros(B)
        for t in range(w * R, min(w * R + R, T)):
            Bv, C = g[t] + cp[t] * Bv, cp[t] * C
        maps.append((C, Bv))
    dbase, last = torch.empty_like(g), None
    for w in range(WARPS):
        x = torch.zeros(B)
        for u in range(w):
            x = maps[u][1] + maps[u][0] * x
        for t in range(w * R, min(w * R + R, T)):
            x = g[t] + cp[t] * x
            dbase[t] = x
            last = x
    out_tp1 = torch.cat([out[1:], init[None]])
    return dbase, dbase * out_tp1, coef[-1] * last


def kernel_scan(base, coef, init, K=None):
    """The forward as the kernels take it: the short kernel up to T = 32,
    the tiled scan above (or at any T with K given)."""
    if K is None and base.shape[0] <= SHORT_T:
        return short_scan(base, coef, init)
    return scan_blocking(base, coef, init, K)


def kernel_adjoint(g, coef, out, init, K=None):
    if K is None and g.shape[0] <= SHORT_T:
        return short_adjoint(g, coef, out, init)
    return adjoint_blocking(g, coef, out, init, K)


def _shift(x, d, up):
    """Lane j takes lane j - d's value (up) or lane j + d's (down); lanes
    with no such neighbour keep their own, as __shfl_up/down_sync do."""
    y = x.clone()
    if up:
        y[d:] = x[:-d]
    else:
        y[:-d] = x[d:]
    return y


def _tree(C, Bv, up):
    """The shuffle tree: lane j ends with the map of lanes 0..j (up, a
    prefix) or j..31 (down, a suffix), its own map outermost."""
    lane = torch.arange(LANES)[:, None]
    for d in (1, 2, 4, 8, 16):
        Cn, Bn = _shift(C, d, up), _shift(Bv, d, up)
        take = lane >= d if up else lane + d < LANES
        Bv, C = torch.where(take, Bv + C * Bn, Bv), torch.where(take, C * Cn,
                                                                C)
    return C, Bv


def _rows(x, t0, K, fill):
    """(K, 32, B): x's rows t0 + j*K + s, lane j, step s; `fill` outside
    [0, T)."""
    T = x.shape[0]
    idx = t0 + torch.arange(LANES)[None, :] * K + torch.arange(K)[:, None]
    ok = (idx >= 0) & (idx < T)
    return torch.where(ok[..., None], x[idx.clamp(0, T - 1)],
                       torch.full((), fill))


def scan_blocking(base, coef, init, K=None):
    """out_t = base_t + coef_t * out_{t+1}, out_T = init, blocked as the
    forward kernel blocks it: passes from the last rows to the first."""
    T, B = base.shape
    K = K or choose_k(T)
    rows = LANES * K
    out = torch.empty_like(base)
    carry = init.clone()
    for p in reversed(range(-(-T // rows))):
        t0 = p * rows
        n = min(rows, T - t0)
        b, c = _rows(base, t0, K, 0.0), _rows(coef, t0, K, 0.0)
        r = (torch.arange(LANES)[None, :] * K +
             torch.arange(K)[:, None])[..., None]  # (K, 32, 1)
        C, Bv = torch.ones(LANES, B), torch.zeros(LANES, B)
        for s in reversed(range(K)):
            on = r[s] < n
            Bv = torch.where(on, b[s] + c[s] * Bv, Bv)
            C = torch.where(on, c[s] * C, C)
        C, Bv = _tree(C, Bv, up=False)
        v = Bv + C * carry
        acc = torch.cat([v[1:], carry[None]])  # the value after my rows
        for s in reversed(range(K)):
            on = r[s] < n
            acc = torch.where(on, b[s] + c[s] * acc, acc)
            rows_s = t0 + r[s, :, 0]
            keep = rows_s < T
            out[rows_s[keep]] = acc[keep]
        carry = acc[0]
    return out


def adjoint_blocking(g, coef, out, init, K=None):
    """(dbase, dcoef, dinit) of the scan, blocked as the adjoint kernel
    blocks it: a_t = g_t + coef_{t-1} a_{t-1} in passes from the first
    rows to the last."""
    T, B = g.shape
    K = K or choose_k(T)
    rows = LANES * K
    dbase = torch.empty_like(g)
    carry = torch.zeros(B)
    for p in range(-(-T // rows)):
        t0 = p * rows
        n = min(rows, T - t0)
        gg, cp = _rows(g, t0, K, 0.0), _rows(coef, t0 - 1, K, 0.0)
        r = (torch.arange(LANES)[None, :] * K +
             torch.arange(K)[:, None])[..., None]
        C, Bv = torch.ones(LANES, B), torch.zeros(LANES, B)
        for s in range(K):
            on = r[s] < n
            Bv = torch.where(on, gg[s] + cp[s] * Bv, Bv)
            C = torch.where(on, cp[s] * C, C)
        C, Bv = _tree(C, Bv, up=True)
        v = Bv + C * carry
        acc = torch.cat([carry[None], v[:-1]])  # a before my rows
        for s in range(K):
            on = r[s] < n
            acc = torch.where(on, gg[s] + cp[s] * acc, acc)
            rows_s = t0 + r[s, :, 0]
            keep = rows_s < T
            dbase[rows_s[keep]] = acc[keep]
        carry = acc[(n - 1) // K]
    out_tp1 = torch.cat([out[1:], init[None]])
    return dbase, dbase * out_tp1, coef[-1] * carry


def _inputs(T, B, dones, seed=0):
    rng = np.random.default_rng(seed + 100 * T + B)
    base = rng.standard_normal((T, B)).astype(np.float32)
    coef = (0.99 * rng.random((T, B))).astype(np.float32)
    if dones:
        coef[rng.random((T, B)) < 0.2] = 0.0
        coef[T - 1, ::2] = 0.0
    init = rng.standard_normal((B,)).astype(np.float32)
    g = rng.standard_normal((T, B)).astype(np.float32)
    return base, coef, init, g


CASES = [(T, B) for T in (1, 7, 31, 32, 33, 100) for B in (1, 5, 32)]


@pytest.mark.parametrize("dones", [False, True])
@pytest.mark.parametrize("T,B", CASES)
def test_scan_blocking_matches_jax_ref(T, B, dones):
    base, coef, init, _ = _inputs(T, B, dones)
    want = np.asarray(jax_dr(jnp.asarray(base), jnp.asarray(coef),
                             jnp.asarray(init)))
    args = [torch.tensor(a) for a in (base, coef, init)]
    # the kernels' choice, and the tiled scan at one row a lane at every
    # T: passes of 32 rows joined by their carries
    for K in (None, 1):
        np.testing.assert_allclose(kernel_scan(*args, K=K).numpy(), want,
                                   **TOL)


@pytest.mark.parametrize("dones", [False, True])
@pytest.mark.parametrize("T,B", CASES)
def test_adjoint_blocking_matches_jax_vjp(T, B, dones):
    base, coef, init, g = _inputs(T, B, dones)
    out, vjp = jax.vjp(jax_dr, jnp.asarray(base), jnp.asarray(coef),
                       jnp.asarray(init))
    want = vjp(jnp.asarray(g))
    args = [torch.tensor(np.asarray(a)) for a in (g, coef, out, init)]
    for K in (None, 1):
        for got, w in zip(kernel_adjoint(*args, K=K), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


def test_blocking_passes_at_a_long_horizon():
    """T = 1100 takes three passes of 512 rows at K = 16."""
    base, coef, init, g = _inputs(1100, 5, True)
    out, vjp = jax.vjp(jax_dr, jnp.asarray(base), jnp.asarray(coef),
                       jnp.asarray(init))
    np.testing.assert_allclose(
        scan_blocking(*(torch.tensor(a) for a in (base, coef, init))).numpy(),
        np.asarray(out), **TOL)
    args = [torch.tensor(np.asarray(a)) for a in (g, coef, out, init)]
    for got, w in zip(adjoint_blocking(*args), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


def test_forward_packed_arguments_match_the_c_struct():
    """ScanFwdParams (80 bytes): base, coef, init, out; the (row, column)
    element strides of base and coef, init's stride; T, B. Strided and
    stride-0 views are passed as they lie."""
    assert sk.FWD_PARAMS.size == 80
    T, B = 7, 5
    base = torch.zeros((B, T)).t()                  # strides (1, T)
    coef = torch.zeros(()).expand(T, B)             # strides (0, 0)
    init = torch.zeros((2 * B,))[::2]               # stride 2
    out = torch.empty((T, B))
    f = sk.FWD_PARAMS.unpack(sk.fwd_params(base, coef, init, out))
    assert f == (base.data_ptr(), coef.data_ptr(), init.data_ptr(),
                 out.data_ptr(), 1, T, 0, 0, 2, T, B)


@pytest.mark.parametrize("need", [(True, True, True), (False, False, True),
                                  (True, False, False)])
def test_adjoint_packed_arguments_match_the_c_struct(need):
    """ScanAdjParams (120 bytes): g, coef, out, init, dbase, dcoef, dinit
    (0 where not asked for); the strides of g, coef, out, init's stride;
    T, B."""
    assert sk.ADJ_PARAMS.size == 120
    T, B = 6, 3
    g = torch.zeros(()).expand(T, B)                # autograd's expanded
    coef, out = torch.zeros((T, B)), torch.zeros((T, 2 * B))[:, ::2]
    init = torch.zeros((B,))
    grads = [torch.empty((T, B)) if need[0] else None,
             torch.empty((T, B)) if need[1] else None,
             torch.empty((B,)) if need[2] else None]
    f = sk.ADJ_PARAMS.unpack(sk.adj_params(g, coef, out, init, *grads))
    assert f[:4] == (g.data_ptr(), coef.data_ptr(), out.data_ptr(),
                     init.data_ptr())
    assert f[4:7] == tuple(t.data_ptr() if t is not None else 0
                           for t in grads)
    assert f[7:] == (0, 0, B, 1, 2 * B, 2, 1, T, B)
