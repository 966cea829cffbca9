"""Fused prioritized sampling on the Hopper kernel (the port of
src/repro/kernels/replay_sample/ops.py). The reference lifts (C,) vectors
into the Pallas kernel's (1, C) layout; the CUDA kernel takes (C,)
vectors, so this layer only casts."""
import torch

from repro_torch.kernels.replay_sample.kernel import prioritized_sample_c


def prioritized_sample(prio, size, gumbel, n, alpha=0.6, beta=0.4,
                       eps=1e-6):
    """prio (C,) raw priorities, size int32 scalar tensor, gumbel (C,)
    standard Gumbel noise. Returns (idx (n,) int32, w (n,) f32)."""
    f32 = torch.float32
    size = torch.as_tensor(size, device=prio.device).to(torch.int32)
    return prioritized_sample_c(prio.to(f32).contiguous(),
                                gumbel.to(f32).contiguous(),
                                size.reshape(1), n, alpha=float(alpha),
                                beta=float(beta), eps=float(eps))
