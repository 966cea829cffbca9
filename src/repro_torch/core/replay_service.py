"""Sharded replay service (survey §3: Gorila's Replay Memory; Ape-X puts
replay on its own sharded service), the port of
src/repro/core/replay_service.py for a replay group held on one device.

`ShardedPrioritizedReplay` is ONE logical `PrioritizedReplay` of global
`capacity` over a replay group of `n_shards` members, member r owning
the contiguous slots ``[r*chunk, (r+1)*chunk)`` (chunk =
capacity/n_shards) of the store and the priorities. The reference runs
one member per device inside shard_map (or vmap, as its tests do); here
the group's members share one card and every sharded tensor carries
their leading (n_shards, ...) dimension: store leaves (R, chunk, ...),
`prio` (R, chunk), and `ptr`/`size` scalars shared by the group. The
group's collectives become operations over that dimension
(core/topology.py).

The interface is the port's `PrioritizedReplay`'s, draw for draw and
bitwise its fused path given the same Gumbel vector:

  insert      the global ring plan (`_ring_fit`) on the shared ptr; each
              row lands in its owner's slice. The Ape-X max-priority
              default is the max over every shard (the reference's
              `pmax`; max is association-free).
  sample      ONE (capacity,) Gumbel vector, the flat buffer's draw, seen
              as (R, chunk); each shard's top-k candidates against its
              LOCAL filled count (`shard_gumbel_topk`, the CUDA kernel
              `shard_topk_c` on the card), merged shard-major, and one
              stable top-n over the R*k candidates. Stable ties toward
              the lower position and the shard-major merge keep global
              index order among candidates, so the indices are one top-n
              over the flat scores. IS weights against the GLOBAL
              priority mass (`prioritized_weights_ref` over every
              shard's priorities); rows assembled by owner
              (`psum_select`).
  write-back  priority updates routed to the owning shard.

`shard_state` / `unshard_state` convert between the flat form agents init
and checkpoints store, and the sharded form, so fits and checkpoints stay
independent of the plan.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.replay import _ring_fit, gumbel_noise
from repro_torch.core.replay_sample import shard_gumbel_topk
from repro_torch.core.topology import (all_gather_shards, local_shard,
                                       psum_select)
from repro_torch.kernels.replay_sample.ref import prioritized_weights_ref


@dataclasses.dataclass
class ShardedPrioritizedReplay:
    """One logical prioritized buffer of `capacity` slots sharded
    1/n_shards per member of the replay axis `axis`; every method takes
    and returns the group's stacked state (see module doc)."""
    capacity: int          # GLOBAL capacity (sum over the axis)
    axis: str              # replay-role axis name
    n_shards: int
    alpha: float = 0.6
    beta: float = 0.4
    eps: float = 1e-6
    # the per-shard draw runs the CUDA kernel for CUDA tensors (the
    # reference's `fused`); False runs its plain version on the card too
    # (a cross-check)
    use_kernel: bool = True

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"replay axis {self.axis!r}: n_shards "
                             f"{self.n_shards} < 1")
        if self.capacity % self.n_shards:
            raise ValueError(
                f"replay axis {self.axis!r}: replay capacity "
                f"{self.capacity} is not divisible by the axis size "
                f"{self.n_shards} — each member owns a contiguous "
                f"1/{self.n_shards} slice of the logical buffer; pick "
                f"a capacity that is a multiple of the axis size")

    @property
    def chunk(self) -> int:
        return self.capacity // self.n_shards

    # ---- owner routing ------------------------------------------------
    def _owner(self, idx):
        """Global slot indices -> (owning shard, local index)."""
        idx = idx.long()
        return idx // self.chunk, idx % self.chunk

    # ---- PrioritizedReplay interface ---------------------------------
    def init(self, example):
        """Empty group state: zero store of (R, chunk) rows shaped like
        each example tensor, zero priorities, ptr = size = 0."""
        dev = next(iter(example.values())).device
        lead = (self.n_shards, self.chunk)
        store = {k: torch.zeros(lead + tuple(a.shape), dtype=a.dtype,
                                device=dev) for k, a in example.items()}
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return {"store": store, "prio": torch.zeros(lead, device=dev),
                "ptr": zero, "size": zero.clone()}

    def add_batch(self, state, batch, priorities=None):
        """The global ring plan; each row written into its owner's slice.
        Bitwise the flat `PrioritizedReplay.add_batch`, slice by slice."""
        n = next(iter(batch.values())).shape[0]
        idx, batch, priorities, ptr = _ring_fit(state, batch, self.capacity,
                                                priorities)
        owner, local = self._owner(idx)
        store = {k: s.index_put((owner, local), batch[k])
                 for k, s in state["store"].items()}
        if priorities is None:  # new samples get max priority (Ape-X)
            priorities = torch.clamp(state["prio"].max(), min=1.0).expand(
                idx.shape[0])
        prio = state["prio"].index_put((owner, local), priorities)
        return {"store": store, "prio": prio, "ptr": ptr,
                "size": torch.clamp(state["size"] + n, max=self.capacity)}

    def noise(self, generator, n):
        """ONE (capacity,) Gumbel vector, the flat fused buffer's draw,
        seen as the (R, chunk) slices of the shards."""
        return local_shard(gumbel_noise(generator, (self.capacity,)),
                           self.n_shards)

    def sample_with(self, state, g, n):
        """-> (batch, GLOBAL idx (n,) int32, is_weights (n,)) for the
        group's Gumbel noise `g` (see `noise`); draw for draw the flat
        fused path's. Nothing here reads a tensor on the host."""
        R, chunk = self.n_shards, self.chunk
        g = g.reshape(R, chunk)
        dev = state["prio"].device
        nvalid = torch.clamp(state["size"], min=1)
        shard = torch.arange(R, device=dev)
        # the max(size, 1) guard is GLOBAL: slot 0 of shard 0 stands in
        # when the buffer is empty; other shards give only -inf
        local_valid = torch.clamp(nvalid - shard * chunk, 0, chunk).to(
            torch.int32)
        k = min(n, chunk)
        s, li = shard_gumbel_topk(state["prio"], local_valid, g, k,
                                  self.alpha, self.eps,
                                  use_kernel=self.use_kernel)
        cand_s = s.reshape(-1)                       # (R*k,) shard-major
        cand_i = (li + (shard * chunk).to(torch.int32)[:, None]).reshape(-1)
        pos = torch.sort(cand_s, descending=True, stable=True).indices[:n]
        idx = cand_i[pos]
        idx = torch.where(torch.arange(n, device=dev) < nvalid, idx,
                          idx[0]).to(torch.int32)
        # IS weights against the GLOBAL priority mass, the flat draw's
        # expressions verbatim
        w = prioritized_weights_ref(all_gather_shards(state["prio"]),
                                    state["size"], idx, self.alpha,
                                    self.beta, self.eps)
        # each member gathers at its local index (clamped where it does
        # not own the slot: garbage that psum_select masks to zero)
        local = idx.long()[None, :] - shard[:, None] * chunk     # (R, n)
        own = (local >= 0) & (local < chunk)
        local = torch.clamp(local, 0, chunk - 1)
        batch = {k: psum_select(st[shard[:, None], local], own)
                 for k, st in state["store"].items()}
        return batch, idx, w

    def sample(self, state, generator, n):
        return self.sample_with(state, self.noise(generator, n), n)

    def update_priorities(self, state, idx, td_errors):
        """Write-back routed to the owning shard; surplus positions repeat
        the top draw with its own value, as on the flat buffer."""
        owner, local = self._owner(idx)
        prio = state["prio"].index_put((owner, local),
                                       td_errors.abs() + self.eps)
        return dict(state, prio=prio)

    # ---- the flat form (Trainer / checkpoint seam) --------------------
    def shard_state(self, state):
        """Flat buffer state (capacity-sized leaves, the form agents init
        and checkpoints store) -> the group's stacked state."""
        return {"store": {k: local_shard(s, self.n_shards)
                          for k, s in state["store"].items()},
                "prio": local_shard(state["prio"], self.n_shards),
                "ptr": state["ptr"], "size": state["size"]}

    def unshard_state(self, state):
        """Inverse of `shard_state`: the flat buffer."""
        return {"store": {k: all_gather_shards(s)
                          for k, s in state["store"].items()},
                "prio": all_gather_shards(state["prio"]),
                "ptr": state["ptr"], "size": state["size"]}
