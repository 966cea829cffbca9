"""V-trace off-policy correction (IMPALA, survey §6.1) — public API.

The house seam, as core/advantages.py: with `use_kernel` a CUDA tensor
goes to the Hopper V-trace kernel (kernels/vtrace/ops.py), and a CPU
tensor or `use_kernel=False` to the plain version
(kernels/vtrace/ref.py). Both return detached targets.
"""
import torch

from repro_torch.kernels.vtrace import ops
from repro_torch.kernels.vtrace.ref import vtrace_ref


def vtrace(log_rhos, discounts, rewards, values, bootstrap,
           clip_rho=1.0, clip_c=1.0, use_kernel=False):
    if use_kernel and log_rhos.is_cuda:
        return ops.vtrace(log_rhos, discounts, rewards, values, bootstrap,
                          clip_rho=clip_rho, clip_c=clip_c)
    return vtrace_ref(log_rhos, discounts, rewards, values, bootstrap,
                      clip_rho=clip_rho, clip_c=clip_c)


def epsilon_correction(logp, eps=1e-6):
    """GA3C ε-correction (survey §6.1): bound log-prob away from -inf to
    avoid numerical instability in async gradient estimation."""
    return torch.log(torch.exp(logp) + eps)
