"""Fused prioritized replay sampling — public API (the port of
src/repro/core/replay_sample.py).

The house seam, as core/vtrace.py: with `use_kernel` a CUDA tensor goes
to the Hopper Gumbel-top-k kernel (kernels/replay_sample/ops.py), and a
CPU tensor or `use_kernel=False` to the plain version
(kernels/replay_sample/ref.py). `PrioritizedReplay(fused=True)` samples
through this seam.
"""
from repro_torch.kernels.replay_sample import ops
from repro_torch.kernels.replay_sample.ref import prioritized_sample_ref


def fused_prioritized_sample(prio, size, gumbel, n, alpha=0.6, beta=0.4,
                             eps=1e-6, use_kernel=False):
    """prio (C,), size int32 scalar, gumbel (C,) ~ Gumbel(0,1), n draws
    WITHOUT replacement ∝ p_i^α. Returns (idx (n,) i32, w (n,) f32)."""
    if use_kernel and prio.is_cuda:
        return ops.prioritized_sample(prio, size, gumbel, n, alpha, beta,
                                      eps)
    return prioritized_sample_ref(prio, size, gumbel, n, alpha, beta, eps)
