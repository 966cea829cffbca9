"""Fused prioritized replay sampling — public API (the port of
src/repro/core/replay_sample.py).

The house seam, as core/vtrace.py: with `use_kernel` a CUDA tensor goes
to the Hopper kernels (kernels/replay_sample/ops.py), and a CPU tensor or
`use_kernel=False` to the plain versions (kernels/replay_sample/ref.py).
`PrioritizedReplay(fused=True)` samples through
`fused_prioritized_sample`; the sharded replay service
(core/replay_service.py) draws its per-shard candidates through
`shard_gumbel_topk`.
"""
from repro_torch.kernels.replay_sample import ops
from repro_torch.kernels.replay_sample.ref import (
    prioritized_sample_ref, shard_gumbel_topk_stack_ref)


def fused_prioritized_sample(prio, size, gumbel, n, alpha=0.6, beta=0.4,
                             eps=1e-6, use_kernel=False):
    """prio (C,), size int32 scalar, gumbel (C,) ~ Gumbel(0,1), n draws
    WITHOUT replacement ∝ p_i^α. Returns (idx (n,) i32, w (n,) f32)."""
    if use_kernel and prio.is_cuda:
        return ops.prioritized_sample(prio, size, gumbel, n, alpha, beta,
                                      eps)
    return prioritized_sample_ref(prio, size, gumbel, n, alpha, beta, eps)


def shard_gumbel_topk(prio, nvalid_local, gumbel, k, alpha=0.6, eps=1e-6,
                      use_kernel=False):
    """prio, gumbel (R, chunk): R shards' priorities and slices of the
    global Gumbel noise; nvalid_local (R,) int32 each shard's LOCAL filled
    count (no max(., 1) guard: the caller keeps the global one). Returns
    (scores (R, k) f32 descending, -inf past the count; idx (R, k) int32
    local indices)."""
    if use_kernel and prio.is_cuda:
        return ops.shard_topk(prio, nvalid_local, gumbel, k, alpha, eps)
    return shard_gumbel_topk_stack_ref(prio, nvalid_local, gumbel, k, alpha,
                                       eps)
