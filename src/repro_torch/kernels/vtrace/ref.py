"""Plain PyTorch V-trace (IMPALA, Espeholt et al. 2018); follows
src/repro/kernels/vtrace/ref.py expression by expression.

    δ_t  = ρ_t (r_t + γ_t V_{t+1} − V_t)
    vs_t = V_t + δ_t + γ_t c_t (vs_{t+1} − V_{t+1})
    adv_t = ρ_t (r_t + γ_t vs_{t+1} − V_t)
with ρ_t = min(ρ̄, w_t), c_t = min(c̄, w_t), w_t the IS ratio.
"""
import torch


def vtrace_ref(log_rhos, discounts, rewards, values, bootstrap,
               clip_rho=1.0, clip_c=1.0):
    """All inputs (T, B) time-major; values V_t; bootstrap V_T (B,).
    Returns (vs (T,B), pg_advantages (T,B)), both detached (targets)."""
    rhos = torch.clamp(torch.exp(log_rhos), max=clip_rho)
    cs = torch.clamp(torch.exp(log_rhos), max=clip_c)
    values_tp1 = torch.cat([values[1:], bootstrap[None]], dim=0)
    deltas = rhos * (rewards + discounts * values_tp1 - values)
    acc = torch.zeros_like(bootstrap)
    dvs = []
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        dvs.append(acc)
    vs = values + torch.stack(dvs[::-1])
    vs_tp1 = torch.cat([vs[1:], bootstrap[None]], dim=0)
    pg_adv = rhos * (rewards + discounts * vs_tp1 - values)
    return vs.detach(), pg_adv.detach()
