"""The Hopper V-trace kernel's blocking on the CPU: a plain torch
transcription of csrc/vtrace.cu (the prologue forming rho, g·c and delta
from each row and V at the next; up to T = 32 (`short_vtrace`) each of 8
warps composing the maps of its 4 rows and then the maps of the warps
after it; above (`tiled_vtrace`) each lane composing the maps of its K
rows, a 5-level shuffle tree composing them across 32 lanes, passes of
32K rows from the last to the first joined by the carry and by V at the
row after each pass; the epilogue forming pg_adv from the value entering
each row), against JAX's `vtrace_ref` at ragged T and B, with the clips
(ρ̄, c̄) = (1, 1), (0.5, 2) and (2, 0.5), and discounts 0 at dones.
Beside it, the host side the CPU reaches: the packed arguments
(`VtraceParams`), field by field, and the IMPALA loss's call of the
V-trace seam.

Inputs come from numpy with a fixed seed. Tolerance: atol = rtol = 1e-5
(1e-4 at T = 2048), `chip_smoke.scan_tol`: the same f32 recurrence
composed in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.vtrace.ref import vtrace_ref as jax_vtrace_ref
from repro_torch.kernels.vtrace import kernel as vk

LANES, WARPS, SHORT_T = 32, 8, 32


def choose_k(T):
    """Rows a lane takes per pass of the tiled kernel (T > 32)."""
    return 4 if T <= 128 else 16


def tol(T):
    t = 1e-5 if T <= 128 else 1e-4
    return dict(atol=t, rtol=t)


def prologue(lr, g, r, v, v_next, clip_rho, clip_c):
    """(rho, g·c, delta) of each row: e^{log rho} once, clipped twice."""
    e = torch.exp(lr)
    rho = torch.clamp(e, max=clip_rho)
    return rho, g * torch.clamp(e, max=clip_c), rho * (r + g * v_next - v)


def short_vtrace(lr, g, r, v, boot, clip_rho=1.0, clip_c=1.0):
    """T <= 32 as vtrace_short takes it: warp w composes the maps of rows
    4w..4w+3, composes the maps of the warps after it onto acc_T = 0, and
    plays its rows, pg_adv from V_{t+1} plus the value entering row t."""
    T, B = lr.shape
    R = SHORT_T // WARPS
    vn = torch.cat([v[1:], boot[None]])   # V_{t+1}, V_T = bootstrap
    rho, coef, delta = prologue(lr, g, r, v, vn, clip_rho, clip_c)
    maps = []
    for w in range(WARPS):
        C, Bv = torch.ones(B), torch.zeros(B)
        for t in reversed(range(w * R, min(w * R + R, T))):
            Bv, C = delta[t] + coef[t] * Bv, coef[t] * C
        maps.append((C, Bv))
    vs, adv = torch.empty_like(lr), torch.empty_like(lr)
    for w in range(WARPS):
        x = torch.zeros(B)
        for u in reversed(range(w + 1, WARPS)):
            x = maps[u][1] + maps[u][0] * x
        for t in reversed(range(w * R, min(w * R + R, T))):
            adv[t] = rho[t] * (r[t] + g[t] * (vn[t] + x) - v[t])
            x = delta[t] + coef[t] * x
            vs[t] = v[t] + x
    return vs, adv


def _shift_down(x, d):
    """Lane j takes lane j + d's value; the last d lanes keep their own,
    as __shfl_down_sync does."""
    y = x.clone()
    y[:-d] = x[d:]
    return y


def _suffix_tree(C, Bv):
    """The shuffle tree: lane j ends with the map of lanes j..31, its own
    map outermost."""
    lane = torch.arange(LANES)[:, None]
    for d in (1, 2, 4, 8, 16):
        Cn, Bn = _shift_down(C, d), _shift_down(Bv, d)
        take = lane + d < LANES
        Bv, C = (torch.where(take, Bv + C * Bn, Bv),
                 torch.where(take, C * Cn, C))
    return C, Bv


def tiled_vtrace(lr, g, r, v, boot, clip_rho=1.0, clip_c=1.0, K=None):
    """T > 32 as vtrace_tiled<K> takes it (or any T with K given): passes
    of 32K rows from the last to the first, the carry (acc at the first
    row of the pass before in the loop) and V at that row between them."""
    T, B = lr.shape
    K = K or choose_k(T)
    rows = LANES * K
    vs, adv = torch.empty_like(lr), torch.empty_like(lr)
    carry, v_after = torch.zeros(B), boot.clone()
    for p in reversed(range(-(-T // rows))):
        t0 = p * rows
        n = min(rows, T - t0)
        r_idx = (torch.arange(LANES)[None, :] * K
                 + torch.arange(K)[:, None])   # (K, 32): row in the pass
        t_idx = t0 + r_idx
        ok = t_idx < T
        tc = t_idx.clamp(max=T - 1)

        def tile(x):  # (K, 32, B), 0 past T as the loads fill
            return torch.where(ok[..., None], x[tc], torch.zeros(()))

        lrt, gt, rt, vt = tile(lr), tile(g), tile(r), tile(v)
        # V at row t + 1: the pass's next row in the tile, past its last
        # row the one carried from the pass before in the loop, past T
        # the bootstrap
        tp = t0 + torch.arange(rows)
        vp = torch.where((tp < T)[:, None], v[tp.clamp(max=T - 1)],
                         torch.zeros(()))
        nxt = torch.where((tp + 1 < T)[:, None],
                          torch.cat([vp[1:], v_after[None]]), boot)
        vin = nxt[r_idx]
        rho, coef, delta = prologue(lrt, gt, rt, vt, vin, clip_rho, clip_c)
        C, Bv = torch.ones(LANES, B), torch.zeros(LANES, B)
        for s in reversed(range(K)):
            on = (r_idx[s] < n)[:, None]
            Bv = torch.where(on, delta[s] + coef[s] * Bv, Bv)
            C = torch.where(on, coef[s] * C, C)
        C, Bv = _suffix_tree(C, Bv)
        after = Bv + C * carry
        acc = torch.cat([after[1:], carry[None]])  # the value after my rows
        for s in reversed(range(K)):
            on = (r_idx[s] < n)[:, None]
            a = rho[s] * (rt[s] + gt[s] * (vin[s] + acc) - vt[s])
            acc = torch.where(on, delta[s] + coef[s] * acc, acc)
            keep = t_idx[s] < T
            adv[t_idx[s][keep]] = a[keep]
            vs[t_idx[s][keep]] = (vt[s] + acc)[keep]
        carry = acc[0]
        v_after = v[t0]
    return vs, adv


def kernel_vtrace(*args, **kw):
    """As the kernel dispatches: the short kernel up to T = 32, else the
    tiled one."""
    fn = short_vtrace if args[0].shape[0] <= SHORT_T else tiled_vtrace
    return fn(*args, **kw)


def _inputs(T, B, seed=0):
    rng = np.random.default_rng(seed + 1000 * T + B)
    log_rhos = (0.7 * rng.standard_normal((T, B))).astype(np.float32)
    dones = rng.random((T, B)) < 0.1
    dones[T - 1, ::2] = True
    discounts = (0.99 * (1.0 - dones)).astype(np.float32)
    rewards = rng.standard_normal((T, B)).astype(np.float32)
    values = rng.standard_normal((T, B)).astype(np.float32)
    boot = rng.standard_normal((B,)).astype(np.float32)
    return log_rhos, discounts, rewards, values, boot


CLIPS = [(1.0, 1.0), (0.5, 2.0), (2.0, 0.5)]
TS = (1, 3, 31, 32, 33, 127, 128, 129, 513, 2048)
CASES = [(T, B) for T in TS for B in (1, 31, 33)]


@pytest.mark.parametrize("clip_rho,clip_c", CLIPS)
@pytest.mark.parametrize("T,B", CASES)
def test_vtrace_blocking_matches_jax_ref(T, B, clip_rho, clip_c):
    args = _inputs(T, B)
    want = jax_vtrace_ref(*map(jnp.asarray, args), clip_rho=clip_rho,
                          clip_c=clip_c)
    got = kernel_vtrace(*(torch.tensor(a) for a in args), clip_rho=clip_rho,
                        clip_c=clip_c)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **tol(T))


@pytest.mark.parametrize("T", [1, 7, 32, 33, 100])
def test_tiled_blocking_at_one_row_a_lane(T):
    """The tiled blocking with K = 1 at every T: passes of 32 rows, so the
    carry and V at the row after each pass join several passes from
    T = 33, and at T <= 32 the tiled kernel takes what the short one
    does."""
    args = [torch.tensor(a) for a in _inputs(T, 9)]
    want = jax_vtrace_ref(*(jnp.asarray(a.numpy()) for a in args),
                          clip_rho=0.5, clip_c=2.0)
    got = tiled_vtrace(*args, clip_rho=0.5, clip_c=2.0, K=1)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **tol(T))


def test_packed_arguments_match_the_c_struct():
    """VtraceParams (144 bytes): log_rhos, discounts, rewards, values,
    bootstrap, vs, pg_adv; the (row, column) element strides of the four
    inputs, bootstrap's stride; clip_rho, clip_c (f32); T, B. Strided and
    stride-0 views are passed as they lie."""
    assert vk.VTRACE_PARAMS.size == 144
    T, B = 7, 5
    log_rhos = torch.zeros((B, T)).t()               # strides (1, T)
    discounts = torch.zeros(()).expand(T, B)         # strides (0, 0)
    rewards = torch.zeros((T, 2 * B))[:, ::2]        # strides (2B, 2)
    values = torch.zeros((T, B))
    boot = torch.zeros((3 * B,))[::3]                # stride 3
    vs, adv = torch.empty((T, B)), torch.empty((T, B))
    f = vk.VTRACE_PARAMS.unpack(vk.vtrace_params(
        log_rhos, discounts, rewards, values, boot, vs, adv, 0.5, 2))
    assert f == (log_rhos.data_ptr(), discounts.data_ptr(),
                 rewards.data_ptr(), values.data_ptr(), boot.data_ptr(),
                 vs.data_ptr(), adv.data_ptr(), 1, T, 0, 0, 2 * B, 2, B, 1,
                 3, 0.5, 2.0, T, B)


@pytest.mark.parametrize("kwargs,use_kernel", [({}, True),
                                               ({"use_kernel": False},
                                                False)])
def test_impala_loss_asks_the_seam_for_the_kernel(monkeypatch, kwargs,
                                                  use_kernel):
    """The IMPALA loss calls the V-trace seam with use_kernel=True by
    default (a CUDA tensor then launches vtrace_tb), and with False when
    asked; on the CPU both compute the plain version."""
    import repro_torch.core.algos.impala as impala_mod
    import repro_torch.envs as envs
    from repro_torch.core import agent as agent_api
    from repro_torch.core.rollout import rollout_fresh
    seen = []
    real = impala_mod.vtrace

    def spy(*args, **kw):
        seen.append(kw.get("use_kernel"))
        return real(*args, **kw)

    monkeypatch.setattr(impala_mod, "vtrace", spy)
    env = envs.make("cartpole")
    ag = agent_api.make("impala", env=env, hidden=(8,), device="cpu",
                        **kwargs)
    assert ag.algo.use_kernel is use_kernel
    state = ag.init(torch.Generator().manual_seed(0))
    traj, env_state = rollout_fresh(ag.policy, ag.actor_policy(state, 0),
                                    env, torch.Generator().manual_seed(1),
                                    4, 3)
    ag.learner_step(state, traj, env.obs(env_state))
    assert seen == [use_kernel]
