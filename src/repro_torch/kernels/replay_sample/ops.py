"""The replay draws on the Hopper kernels (the port of
src/repro/kernels/replay_sample/ops.py). The reference lifts (C,) vectors
into the Pallas kernels' (1, C) layout; the CUDA kernels take (C,) vectors
and (R, chunk) stacks, so this layer only casts."""
import torch

from repro_torch.kernels.replay_sample.kernel import (prioritized_sample_c,
                                                      shard_topk_c)


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


def shard_topk(prio, nvalid, gumbel, k, alpha=0.6, eps=1e-6):
    """prio (R, chunk) raw priorities of R replay shards, nvalid (R,) int32
    LOCAL filled counts on their device, gumbel (R, chunk) the shards'
    slices of the global Gumbel noise. Returns (scores (R, k) f32, idx
    (R, k) int32), -inf past each shard's count (the Pallas kernel's _NEG,
    which its ops.py restores to -inf)."""
    f32 = torch.float32
    return shard_topk_c(prio.to(f32).contiguous(),
                        gumbel.to(f32).contiguous(),
                        nvalid.to(torch.int32).contiguous(), k,
                        alpha=float(alpha), eps=float(eps))
