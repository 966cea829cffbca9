"""Deterministic synthetic LM data (the port of src/repro/data/tokens.py).

Counter-based: the tokens of (step, shard) come from one torch.Generator
seeded by a fixed mixing of (seed, step, shard) (`stream_seed`), so every
worker can make its own shard of any global batch without coordination
or host I/O. The stream is a noisy +1 token walk (90% predictable), so
cross-entropy has a learnable floor well below log(vocab).

The law, the shapes and `optimal_ce` are the reference's; the bits are
not (torch cannot reproduce threefry), so parity tests pass tokens in.
The draw runs on the CPU and the result moves to `device`: the stream is
the same on every device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.networks import stream_seed


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    p_predictable: float = 0.9

    def batch_at(self, step: int, device="cpu"):
        """Full global batch {"tokens": (B, S+1) int32} for `step`."""
        return self.shard_at(step, 0, 1, device)

    def shard_at(self, step: int, shard: int, n_shards: int, device="cpu"):
        """The `shard`-of-`n_shards` slice of the global batch: t0
        uniform, each step +1 with probability p_predictable, else
        uniform in [0, vocab), summed mod vocab."""
        b, S = self.global_batch // n_shards, self.seq_len
        gen = torch.Generator().manual_seed(stream_seed(self.seed, step,
                                                        shard))
        t0 = torch.randint(0, self.vocab, (b, 1), generator=gen)
        rand_step = torch.randint(0, self.vocab, (b, S), generator=gen)
        predict = torch.rand((b, S), generator=gen) < self.p_predictable
        deltas = torch.where(predict, 1, rand_step)
        walk = torch.cat([torch.zeros((b, 1), dtype=deltas.dtype),
                          torch.cumsum(deltas, dim=1)], dim=1)
        tokens = (t0 + walk) % self.vocab
        return {"tokens": tokens.to(torch.int32).to(device)}

    def optimal_ce(self):
        """Entropy floor of the stream (nats/token): the Bayes loss."""
        p = self.p_predictable
        q = (1 - p) / self.vocab
        return -(p + q) * math.log(p + q) - (self.vocab - 1) * (
            q * math.log(max(q, 1e-30)))
