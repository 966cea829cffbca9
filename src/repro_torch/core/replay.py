"""Experience replay (survey §3: the Gorila/Ape-X Replay Memory), the port
of src/repro/core/replay.py.

Fixed-capacity buffers on the device, held as dicts of tensors; every
update returns new tensors and leaves its inputs as they were, as the
reference's pure functions do:
  * `UniformReplay`: Gorila-style uniform sampling.
  * `PrioritizedReplay`: Ape-X proportional prioritization p_i ∝ |TD_i|^α
    with importance-sampling weights w_i ∝ (N p_i)^{-β}, on two paths:
      - legacy (`fused=False`): n independent categorical draws over the
        log-priorities (WITH replacement), argmax(logits + G) with G (n, C)
        Gumbel noise, which is what `jax.random.categorical` computes; the
        IS weights gather the chosen logits and normalize by the scalar
        partition function;
      - fused (`fused=True`): one Gumbel-top-k pass (WITHOUT replacement)
        through `core.replay_sample`, the CUDA kernel for CUDA tensors.

Every sampler takes its noise as a tensor (`sample_with`); `sample` draws
that noise from a torch.Generator first. Tests pass the reference's noise.

Edge cases (both buffers):
  * Sampling from an EMPTY buffer (size == 0) returns slot 0 (the zeros
    `init` wrote) with finite weights; callers gate on warmup/size (see
    algos/dqn.py). `size` stays on the device, so there is no host check.
  * `add_batch` with n > capacity writes only the LAST `capacity` items.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.replay_sample import fused_prioritized_sample


def gumbel_noise(generator, shape) -> torch.Tensor:
    """Standard Gumbel noise on the generator's device, from uniforms
    clamped away from 0 as `jax.random.gumbel` draws them."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def _ring_fit(state, batch, capacity, priorities=None):
    """Ring-write plan for n items: with n > capacity, drop all but the
    last `capacity` (they would be overwritten within this very batch).
    Returns (idx, batch, priorities, new_ptr)."""
    n = next(iter(batch.values())).shape[0]
    drop = max(n - capacity, 0)
    if drop:
        batch = {k: b[drop:] for k, b in batch.items()}
        if priorities is not None:
            priorities = priorities[drop:]
    ptr = state["ptr"]
    idx = (ptr + drop + torch.arange(n - drop, device=ptr.device)) % capacity
    return idx, batch, priorities, (ptr + n) % capacity


def _init(capacity, example):
    """Zero store of `capacity` rows shaped like each example tensor."""
    dev = next(iter(example.values())).device
    store = {k: torch.zeros((capacity,) + tuple(a.shape), dtype=a.dtype,
                            device=dev) for k, a in example.items()}
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return store, zero


def _write(state, batch, capacity, priorities=None):
    """The ring write of `add_batch`: (idx, store, ptr, size, the
    priorities of the written items)."""
    n = next(iter(batch.values())).shape[0]
    idx, batch, priorities, ptr = _ring_fit(state, batch, capacity,
                                            priorities)
    store = {k: s.index_put((idx,), batch[k])
             for k, s in state["store"].items()}
    return (idx, store, ptr, torch.clamp(state["size"] + n, max=capacity),
            priorities)


@dataclasses.dataclass
class UniformReplay:
    capacity: int

    def init(self, example):
        store, zero = _init(self.capacity, example)
        return {"store": store, "ptr": zero, "size": zero.clone()}

    def add_batch(self, state, batch):
        """batch: dict of tensors with leading dim n (n > capacity keeps
        only the last `capacity` items)."""
        _, store, ptr, size, _ = _write(state, batch, self.capacity)
        return {"store": store, "ptr": ptr, "size": size}

    def noise(self, generator, n):
        """(n,) uniforms in [0, 1): one per draw."""
        return torch.rand((n,), generator=generator, device=generator.device)

    def sample_with(self, state, u, n):
        """Uniform over filled slots: slot floor(u·N), N = max(size, 1).
        Empty buffer -> slot-0 zeros. Returns (batch, idx)."""
        N = torch.clamp(state["size"], min=1)
        idx = torch.minimum((u * N).long(), N - 1)
        return {k: s[idx] for k, s in state["store"].items()}, idx

    def sample(self, state, generator, n):
        return self.sample_with(state, self.noise(generator, n), n)


@dataclasses.dataclass
class PrioritizedReplay:
    capacity: int
    alpha: float = 0.6
    beta: float = 0.4
    eps: float = 1e-6
    fused: bool = False   # Gumbel-top-k kernel path (see module doc)
    # the fused draw runs the kernel for CUDA tensors; False runs the
    # plain version on the card too (a cross-check)
    use_kernel: bool = True

    def init(self, example):
        store, zero = _init(self.capacity, example)
        prio = torch.zeros((self.capacity,), device=zero.device)
        return {"store": store, "prio": prio, "ptr": zero,
                "size": zero.clone()}

    def add_batch(self, state, batch, priorities=None):
        idx, store, ptr, size, priorities = _write(state, batch,
                                                   self.capacity, priorities)
        if priorities is None:  # new samples get max priority (Ape-X)
            priorities = torch.clamp(state["prio"].max(), min=1.0).expand(
                idx.shape[0])
        prio = state["prio"].index_put((idx,), priorities)
        return {"store": store, "prio": prio, "ptr": ptr, "size": size}

    def noise(self, generator, n):
        """The draw's Gumbel noise: (C,) on the fused path, (n, C) on the
        legacy path (one categorical draw per row)."""
        shape = (self.capacity,) if self.fused else (n, self.capacity)
        return gumbel_noise(generator, shape)

    def sample_with(self, state, g, n):
        """-> (batch, idx, is_weights) for Gumbel noise `g` (see `noise`).
        Proportional to p_i^α; WITH replacement on the legacy path, WITHOUT
        (Gumbel-top-k) on the fused path. Empty buffer -> finite-weight
        slot-0 draws."""
        if self.fused:
            idx, w = fused_prioritized_sample(
                state["prio"], state["size"], g, n, self.alpha, self.beta,
                self.eps, use_kernel=self.use_kernel)
        else:
            # max(size, 1) keeps slot 0 valid when empty, so the
            # normalization below stays NaN-free
            N = torch.clamp(state["size"], min=1)
            valid = torch.arange(self.capacity, device=N.device) < N
            logits = self.alpha * torch.log(state["prio"] + self.eps)
            logits = torch.where(valid, logits, -torch.inf)
            idx = torch.argmax(g + logits, dim=-1)
            # π_idx gathered from the chosen logits + scalar partition
            # function — no capacity-sized softmax materialization
            unnorm = torch.exp(logits - torch.max(logits))
            w = (N * (unnorm[idx] / unnorm.sum()) + 1e-12) ** (-self.beta)
            w = w / torch.clamp(w.max(), min=1e-12)
        batch = {k: s[idx] for k, s in state["store"].items()}
        return batch, idx, w

    def sample(self, state, generator, n):
        return self.sample_with(state, self.noise(generator, n), n)

    def update_priorities(self, state, idx, td_errors):
        prio = state["prio"].index_put((idx,), td_errors.abs() + self.eps)
        return dict(state, prio=prio)
