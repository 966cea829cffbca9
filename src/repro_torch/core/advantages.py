"""Advantage estimation (GAE / n-step returns) — public API.

The house ref/kernel/ops seam, as core/attention.py: with `use_kernel` a
CUDA tensor goes to the Hopper discounted-return kernel
(kernels/advantages/ops.py, differentiable through its adjoint kernel),
and a CPU tensor or `use_kernel=False` to the plain version
(kernels/advantages/ref.py). There is no fallback: a CUDA tensor with
`use_kernel` launches the kernel or raises.
"""
from repro_torch.kernels.advantages import ops
from repro_torch.kernels.advantages.ref import (discounted_return_ref,
                                                gae_ref, nstep_return_ref)


def discounted_return(base, coef, init, use_kernel=False):
    """out_t = base_t + coef_t * out_{t+1}; time-major (T, B)."""
    if use_kernel and base.is_cuda:
        return ops.discounted_return(base, coef, init)
    return discounted_return_ref(base, coef, init)


def gae(rewards, values, dones, bootstrap, gamma=0.99, lam=0.95,
        use_kernel=False):
    """Generalized advantage estimation, time-major (T, B).
    Returns (advantages, returns)."""
    if use_kernel and rewards.is_cuda:
        return ops.gae(rewards, values, dones, bootstrap, gamma, lam)
    return gae_ref(rewards, values, dones, bootstrap, gamma, lam)


def nstep_return(rewards, dones, bootstrap, gamma=0.99, use_kernel=False):
    """Discounted n-step returns, time-major (T, B) -> (T, B)."""
    if use_kernel and rewards.is_cuda:
        return ops.nstep_return(rewards, dones, bootstrap, gamma)
    return nstep_return_ref(rewards, dones, bootstrap, gamma)
