"""Distributed synchronization mechanisms (survey §6, Fig. 6), the port
of src/repro/core/sync.py: BSP / ASP / SSP as a deterministic staleness
schedule. A worker at step t acts with params `delay[t, w]` learner
updates old:

    BSP: delay ≡ 0 (bulk-synchronous, consistent)
    ASP: delay ~ U[0, max_delay]       (unbounded staleness)
    SSP: delay ~ min(U[0, max_delay], bound)  (stale-synchronous)

The draws come from an explicit torch.Generator. JAX's threefry draws
cannot be reproduced, so the schedules agree with the reference in their
laws (zeros, range, bound), not draw for draw. `train_with_staleness`
and the sync cost model (the reference's fig6 benchmark) are not on the
Trainer's path and are not ported.
"""
from __future__ import annotations

import dataclasses

import torch

MECHANISMS = ("bsp", "asp", "ssp")


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    mechanism: str = "bsp"        # bsp | asp | ssp
    n_workers: int = 4
    max_delay: int = 4            # ASP worst case
    staleness_bound: int = 1      # SSP bound


def pipeline_depth(cfg: SyncConfig) -> int:
    """How far a decoupled rollout producer may run ahead of the learner
    under this discipline (the pipelined Trainer's queue depth): the same
    staleness budget `make_delays` spends as random policy lag. BSP admits
    none, SSP its bound, ASP its worst case."""
    if cfg.mechanism == "bsp":
        return 0
    if cfg.mechanism == "asp":
        return cfg.max_delay
    if cfg.mechanism == "ssp":
        return min(cfg.max_delay, cfg.staleness_bound)
    raise ValueError(cfg.mechanism)


def make_delays(cfg: SyncConfig, n_steps: int, generator):
    """(n_steps, n_workers) int32 delays on the generator's device; BSP
    draws nothing from the generator."""
    shape = (n_steps, cfg.n_workers)
    if cfg.mechanism == "bsp":
        return torch.zeros(shape, dtype=torch.int32,
                           device=generator.device)
    if cfg.mechanism not in ("asp", "ssp"):
        raise ValueError(cfg.mechanism)
    d = torch.randint(0, cfg.max_delay + 1, shape, generator=generator,
                      dtype=torch.int32, device=generator.device)
    if cfg.mechanism == "ssp":
        d = torch.clamp(d, max=cfg.staleness_bound)
    return d
