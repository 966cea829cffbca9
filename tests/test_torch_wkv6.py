"""The port's chunked WKV against the JAX package on the CPU: the plain
version (`wkv6_ref`, y and the final state) against JAX's `wkv6_ref` and
against JAX's `ops.wkv6` (the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it), a carried initial state against JAX's
`wkv_chunked`, and the port's wrapper, which takes the plain version for
CPU tensors (no launch).

It also holds a plain transcription of the Hopper kernel's blocking
(`kernel_blocking`: the streaming path below one sub-chunk, else chunks
cut into sub-chunks of 16 with split exponents across sub-chunks, and
column slices) against JAX's `wkv6_ref`, at the reference's sweep shapes
and at strong decay (logw down to -30 a step, so e^c underflows within a
chunk), and checks the kernel wrapper's host side on CPU tensors: the
checks it raises and the packed argument it builds.

Tolerance: atol = 2e-4, rtol = 1e-3, the reference's own
(tests/test_kernels.py: the same f32 recurrence blocked or summed in
another order). Inputs come from numpy with a fixed seed, with a nonzero
u so the diagonal bonus term is exercised."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked
from repro_torch.kernels.wkv6 import kernel as wk
from repro_torch.kernels.wkv6 import ops
from repro_torch.kernels.wkv6.kernel import wkv6_btHN
from repro_torch.kernels.wkv6.ref import wkv6_ref

TOL = dict(atol=2e-4, rtol=1e-3)
# the reference's sweep (tests/test_kernels.py::test_wkv6_sweep); the
# last needs padding in the reference and masking here
SWEEP = [(2, 100, 3, 16, 32), (1, 64, 2, 64, 64), (1, 37, 1, 8, 16)]


def _inputs(B, T, H, N, seed=0, state=False, strong=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(0.5 * rng.standard_normal((B, T, H, N))).astype(
        np.float32)
    if strong:  # decays down to e^-30 a step: e^c underflows in a chunk
        logw = -rng.uniform(0.0, 30.0, (B, T, H, N)).astype(np.float32)
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


SUB = 16  # steps a sub-chunk of the kernel's chunked path
LOG2E = 1.4426950408889634


def kernel_blocking(r, k, v, logw, u, state=None, chunk=64, cw=16):
    """csrc/wkv6.cu's blocking in plain f32 torch. Below one sub-chunk (T
    or chunk < 16) the per-step recurrence (the streaming path). Else
    chunks of the largest multiple of `chunk` up to 64 steps (the state
    carried across them), zero-padded to sub-chunks of 16. In log2
    units, lc is the cumsum of logw within each sub-chunk, lcp the same a
    row up (0 on a sub-chunk's first row) and tot_s sub-chunk s's total:
    within a sub-chunk the difference exponents 2^{lcp_t - lc_j}; across
    sub-chunks (t in s, j in s' < s) the split (r_t 2^{lcp_t})
    (k_j 2^{tot_{s'} - lc_j}) 2^{tot_{s'+1} + ... + tot_{s-1}}, every
    exponent <= 0; y and S column slice by column slice of width `cw`."""
    B, T, H, N = r.shape
    S = (torch.zeros((B, H, N, N)) if state is None else state.clone())
    if T < SUB or chunk < SUB:
        return wkv6_ref(r, k, v, logw, u, S)
    ys = []
    tri = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool), -1)
    chunk = 64 // chunk * chunk
    for t0 in range(0, T, chunk):
        Lc = min(chunk, T - t0)
        NS = -(-Lc // SUB)
        LP = NS * SUB
        pad = (0, 0, 0, 0, 0, LP - Lc)
        rc, kc, vc, lw = (torch.nn.functional.pad(a[:, t0:t0 + Lc], pad)
                          for a in (r, k, v, logw))
        lc = torch.cumsum((lw * LOG2E).reshape(B, NS, SUB, H, N), dim=2)
        lcp = torch.cat([torch.zeros_like(lc[:, :, :1]), lc[:, :, :-1]], 2)
        tot = lc[:, :, -1]                                   # (B,NS,H,N)
        pre = torch.cumsum(tot, dim=1) - tot                 # before s
        suf = tot.flip(1).cumsum(1).flip(1) - tot            # after s
        lc, lcp = lc.reshape(B, LP, H, N), lcp.reshape(B, LP, H, N)
        score = torch.zeros((B, H, LP, LP))
        for s in range(NS):
            t = slice(SUB * s, SUB * (s + 1))
            d = lcp[:, t, None] - lc[:, None, t]             # (B,t,j,H,N)
            e = torch.where(tri[None, :, :, None, None], torch.exp2(d), 0.0)
            blk = torch.einsum("bthn,bjhn,btjhn->bhtj", rc[:, t], kc[:, t], e)
            blk = blk + torch.diag_embed(
                torch.einsum("bthn,hn,bthn->bht", rc[:, t], u, kc[:, t]))
            score[:, :, t, t] = blk
            for sp in range(s):
                j = slice(SUB * sp, SUB * (sp + 1))
                rh = rc[:, t] * torch.exp2(lcp[:, t])
                kb = kc[:, j] * torch.exp2(tot[:, sp, None] - lc[:, j])
                g = torch.exp2(tot[:, sp + 1:s].sum(1))     # (B,H,N) <= 1
                score[:, :, t, j] = torch.einsum("bthn,bjhn,bhn->bhtj", rh,
                                                 kb, g)
        sub = torch.arange(LP) // SUB
        rt = rc * torch.exp2(pre[:, sub] + lcp)
        kt = kc * torch.exp2(tot[:, sub] - lc) * torch.exp2(suf[:, sub])
        y = torch.zeros((B, LP, H, N))
        for m0 in range(0, N, cw):  # the slices are independent
            m = slice(m0, m0 + cw)
            y[..., m] = (torch.einsum("bhtj,bjhm->bthm", score, vc[..., m])
                         + torch.einsum("bthn,bhnm->bthm", rt, S[..., m]))
            S[..., m] = (torch.exp2(tot.sum(1))[..., None] * S[..., m]
                         + torch.einsum("bjhn,bjhm->bhnm", kt, vc[..., m]))
        ys.append(y[:, :Lc])
    return torch.cat(ys, dim=1), S


BLOCKING = [(*shape, cw) for shape in SWEEP for cw in (8, 16)] + [
    (2, 40, 2, 64, 64, 32), (1, 33, 1, 64, 64, 16), (1, 15, 2, 16, 64, 16),
    (1, 20, 2, 16, 1, 16), (1, 200, 2, 16, 64, 16), (1, 90, 2, 16, 20, 16)]


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("B,T,H,N,chunk,cw", BLOCKING)
def test_kernel_blocking_matches_jax_ref(B, T, H, N, chunk, cw, strong):
    """The split exponents never overflow: at strong decay every factor
    is <= 1 and the result stays finite and within the tolerance of the
    per-step scan, from a carried state and from zero. (The reference
    model's `wkv_chunked`, e^{c_{t-1} - c_j} of a chunk-long cumsum, is
    no oracle there: at strong decay its small exponents lose digits.)"""
    x = _inputs(B, T, H, N, seed=5, state=True, strong=strong)
    for args in (x, x[:5]):
        y, S = kernel_blocking(*_t(args), chunk=chunk, cw=cw)
        assert torch.isfinite(y).all() and torch.isfinite(S).all()
        jy, jS = jax_wkv6_ref(*_j(args))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(S.numpy(), np.asarray(jS), **TOL)


def test_ops_takes_bf16_r_k_v_u():
    """The model's entry on bf16 r, k, v and u (the serve path's dtypes)
    computes the f32 function of their values: JAX's ops.wkv6 on the
    same values."""
    x = _inputs(2, 24, 2, 16, seed=6)
    xb = [torch.tensor(a).to(torch.bfloat16) for a in x]
    y, S = ops.wkv6(xb[0], xb[1], xb[2], torch.tensor(x[3]), xb[4], 16)
    vals = [jnp.asarray(a.float().numpy()) for a in xb]
    want = jax_wkv6(vals[0], vals[1], vals[2], jnp.asarray(x[3]), vals[4],
                    chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    assert y.dtype == S.dtype == torch.float32


def _host_inputs(dtype=torch.float32):
    x = _t(_inputs(2, 5, 3, 8, seed=7, state=True))
    for i in (0, 1, 2, 4):
        x[i] = x[i].to(dtype)
    return x


@pytest.mark.parametrize("dtypes,bits", [((), 0), (("r", "k", "v", "u"), 15),
                                         (("v",), 4), (("u",), 8)])
def test_host_check_takes_f32_and_bf16_r_k_v_u(dtypes, bits):
    x = _t(_inputs(2, 5, 3, 8, seed=7, state=True))
    for name in dtypes:
        i = ("r", "k", "v", "u").index(name)
        x[(0, 1, 2, 4)[i]] = x[(0, 1, 2, 4)[i]].to(torch.bfloat16)
    assert wk._check(*x, 4) == bits
    assert wk._check(*x[:5], None, 64) == bits


@pytest.mark.parametrize("bad,err,match", [
    ("grad", RuntimeError, "requires grad"),
    ("ndim", ValueError, "r must be"),
    ("shape", ValueError, "u is"),
    ("float64", ValueError, "v is torch.float64, expected float32 or"),
    ("bf16_logw", ValueError, "logw is torch.bfloat16, expected float32"),
    ("bf16_state", ValueError, "state is torch.bfloat16, expected float32"),
    ("strided", ValueError, "k must be contiguous"),
    ("head_dim", ValueError, "N = 80"),
    ("chunk", ValueError, "chunk = 65")])
def test_host_check_refuses_what_the_kernel_does_not_take(bad, err, match):
    """Each refusal of the kernel's wrapper, checked on CPU tensors (the
    checks run before any launch, on any device)."""
    N = 80 if bad == "head_dim" else 8
    r, k, v, logw, u, s0 = _t(_inputs(1, 6, 2, N, seed=8, state=True))
    chunk = 65 if bad == "chunk" else 4
    if bad == "grad":
        r.requires_grad_(True)
    elif bad == "ndim":
        r = r[0]
    elif bad == "shape":
        u = u[:1]
    elif bad == "float64":
        v = v.double()
    elif bad == "bf16_logw":
        logw = logw.to(torch.bfloat16)
    elif bad == "bf16_state":
        s0 = s0.to(torch.bfloat16)
    elif bad == "strided":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(err, match=match):
        wk._check(r, k, v, logw, u, s0, chunk)


def test_packed_arguments_match_the_c_struct():
    """PARAMS packs the 88 bytes of `WkvParams` in csrc/wkv6.cu: eight
    pointers, then B, T, H, N, chunk and the dtype bits."""
    src = (wk.__file__.rsplit("/", 1)[0] + "/csrc/wkv6.cu")
    text = open(src).read()
    assert "static_assert(sizeof(WkvParams) == 88" in text
    assert wk.PARAMS.size == 88
    f = wk.PARAMS.unpack(wk.PARAMS.pack(*range(1, 9), 2, 5, 3, 8, 4, 15))
    assert f[8:14] == (2, 5, 3, 8, 4, 15)
    assert math.prod(f[:8]) == math.factorial(8)
