"""V-trace on the Hopper kernel (the port of
src/repro/kernels/vtrace/ops.py). The reference pads B to 128; the CUDA
kernel masks b < B instead, so nothing is padded or copied."""
import torch

from repro_torch.kernels.vtrace.kernel import vtrace_tb


def vtrace(log_rhos, discounts, rewards, values, bootstrap,
           clip_rho=1.0, clip_c=1.0):
    f32 = torch.float32
    vs, adv = vtrace_tb(log_rhos.to(f32), discounts.to(f32),
                        rewards.to(f32), values.to(f32), bootstrap.to(f32),
                        clip_rho=clip_rho, clip_c=clip_c)
    return vs.detach(), adv.detach()
