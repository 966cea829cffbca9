"""Distributed synchronization mechanisms (survey §6, Fig. 6), the port
of src/repro/core/sync.py: BSP / ASP / SSP as a deterministic staleness
schedule. A worker at step t acts with params `delay[t, w]` learner
updates old:

    BSP: delay ≡ 0 (bulk-synchronous, consistent)
    ASP: delay ~ U[0, max_delay]       (unbounded staleness)
    SSP: delay ~ min(U[0, max_delay], bound)  (stale-synchronous)

The draws come from an explicit torch.Generator. JAX's threefry draws
cannot be reproduced, so the schedules agree with the reference in their
laws (zeros, range, bound), not draw for draw.

Off the Trainer's path, the reference's fig6 harness: `train_with_
staleness` (data-parallel SGD where worker w at step t takes its
gradient against params `delays[t, w]` updates old) and `sync_cost_
model` (the wall time of a step under straggling workers, §6.2); each
takes its random draws as given tensors or from a generator.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

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


def train_with_staleness(loss_fn, params0, optimizer, batches, delays):
    """Data-parallel training under a staleness schedule.

    loss_fn(params, batch) -> scalar, params a dict of tensors;
    batches: a dict (nested dicts allowed) of tensors with leading (T, W);
    delays: (T, W) int tensor, delay d => the gradient is taken against
    the params d updates old (clipped to the largest delay). Each step
    applies the workers' mean gradient. Returns (final params, the
    workers' mean loss at each step, (T,))."""
    from repro_torch.core.agent import value_and_grad
    from repro_torch.core.positions import tree_map
    T, W = delays.shape
    table = delays.tolist()
    D = max((d for row in table for d in row), default=0)
    hist = [params0] * (D + 1)          # hist[d]: the params d updates old
    params, opt_state = params0, optimizer.init(params0)
    losses = []
    for t in range(T):
        ls, gs = [], []
        for w in range(W):
            batch = tree_map(lambda a: a[t, w], batches)
            loss, g = value_and_grad(loss_fn, hist[min(table[t][w], D)],
                                     batch)
            ls.append(loss)
            gs.append(g)
        g = {k: torch.stack([x[k] for x in gs]).mean(0) for k in gs[0]}
        params, opt_state = optimizer.apply(params, opt_state, g)
        hist = [params] + hist[:-1]
        losses.append(torch.stack(ls).mean())
    return params, torch.stack(losses)


def sync_cost_model(cfg: SyncConfig, t_compute_mean, t_compute_std,
                    n_steps, generator=None, draws=None):
    """Analytic throughput model (survey §6.2 synchronization barrier):
    the summed per-step wall time when worker step times are
    N(mean, std), floored at 1e-3. BSP waits for the slowest worker;
    ASP takes the mean; SSP runs `staleness_bound` - 1 free steps at the
    mean and one barrier step at the window's max. The standard normal
    draws (n_steps, n_workers) come as `draws`, else from `generator`."""
    if draws is None:
        draws = torch.randn((n_steps, cfg.n_workers), generator=generator,
                            device=generator.device)
    t = torch.clamp(t_compute_mean + t_compute_std * draws, min=1e-3)
    if cfg.mechanism == "bsp":
        return t.amax(dim=1).sum()
    if cfg.mechanism == "asp":
        return t.mean(dim=1).sum()
    if cfg.mechanism != "ssp":
        raise ValueError(cfg.mechanism)
    b = max(cfg.staleness_bound, 1)
    pad = (-n_steps) % b
    tw = F.pad(t, (0, 0, 0, pad)).reshape(-1, b, cfg.n_workers)
    return (tw.mean(dim=(1, 2)) * (b - 1) + tw.amax(dim=(1, 2))).sum()
