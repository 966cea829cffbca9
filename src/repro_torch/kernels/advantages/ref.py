"""Plain PyTorch advantage estimators via one shared reverse linear scan;
follows src/repro/kernels/advantages/ref.py expression by expression.

GAE and n-step returns are both instances of

    out_t = base_t + coef_t * out_{t+1},      out_T = init

  * n-step return:  base = r_t,  coef = γ (1 − done_t),   init = V(s_T)
  * GAE advantage:  base = δ_t,  coef = γ λ (1 − done_t), init = 0
    with δ_t = r_t + γ (1 − done_t) V_{t+1} − V_t.

`discounted_return_adjoint_ref` is the plain adjoint of that scan (the
backward the CUDA kernel's autograd Function runs as a kernel too).
"""
import torch


def discounted_return_ref(base, coef, init):
    """Reverse scan of `out_t = base_t + coef_t * out_{t+1}`.

    base/coef: (T, B) time-major; init: (B,) terminal carry.
    Returns out (T, B). Differentiable through torch autograd."""
    acc = init
    outs = []
    for t in range(base.shape[0] - 1, -1, -1):
        acc = base[t] + coef[t] * acc
        outs.append(acc)
    return torch.stack(outs[::-1])


def discounted_return_adjoint_ref(g, coef, out, init):
    """Adjoint of the scan, forward in time: with `g` = dL/dout (T, B),
    a_0 = g_0 and a_t = g_t + coef_{t−1}·a_{t−1}; returns (dbase = a,
    dcoef = a_t·out_{t+1} with out_T = init, dinit = coef_{T−1}·a_{T−1})."""
    a = g[0]
    adj = [a]
    for t in range(1, g.shape[0]):
        a = g[t] + coef[t - 1] * a
        adj.append(a)
    dbase = torch.stack(adj)
    out_tp1 = torch.cat([out[1:], init[None]], dim=0)
    return dbase, dbase * out_tp1, coef[-1] * a


def gae_ref(rewards, values, dones, bootstrap, gamma=0.99, lam=0.95):
    """Time-major (T, B). Returns (advantages, returns)."""
    values_tp1 = torch.cat([values[1:], bootstrap[None]], dim=0)
    nonterm = 1.0 - dones.to(torch.float32)
    deltas = rewards + gamma * nonterm * values_tp1 - values
    adv = discounted_return_ref(deltas, gamma * lam * nonterm,
                                torch.zeros_like(bootstrap))
    return adv, adv + values


def nstep_return_ref(rewards, dones, bootstrap, gamma=0.99):
    """Discounted n-step returns R_t = r_t + γ(1−done_t) R_{t+1},
    R_T = bootstrap. Time-major (T, B) -> (T, B)."""
    discounts = gamma * (1.0 - dones.to(torch.float32))
    return discounted_return_ref(rewards, discounts, bootstrap)
