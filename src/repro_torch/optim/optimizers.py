"""Optimizers over flat dicts of tensors (the port of
src/repro/optim/optimizers.py): AdamW, SGD(+momentum), Lion, global-norm
clipping, cosine LR schedule, with the reference's init/update interface.

States are dicts of tensors keyed like the params, so they move and
checkpoint with them. Every update is functional: it returns new tensors
and leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.tracing import spanned


def tree_map(fn, *trees):
    """`fn` over the leaves of flat dicts of tensors with the same keys."""
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)
    # Optional split of `update` for ZeRO-style sharded application: `pre`
    # must see the FULL gradient dict (global-norm clipping: its norm over
    # a 1/n shard would differ), `shard_update` is the per-coordinate
    # remainder, with ``update(g, s, p) == shard_update(pre(g), s, p)``.
    # Both stay None for per-coordinate optimizers (adamw / sgd / lion).
    pre: Optional[Callable] = None
    shard_update: Optional[Callable] = None

    @spanned("repro_torch.rl.learner.optimizer")
    def apply(self, params, state, grads):
        updates, state = self.update(grads, state, params)
        return tree_map(lambda p, u: p + u, params, updates), state

    @spanned("repro_torch.rl.learner.optimizer")
    def apply_leafwise(self, params, state, grads, group_numel=1 << 26):
        """`apply` on dicts it updates in place, a group of leaves at a
        time (consecutive leaves of at most `group_numel` elements, a
        larger leaf alone): each group's new params and state entries
        replace the old ones before the next group is updated, so the
        peak holds one copy of the params and the state (and, under a
        clip, the clipped gradients) instead of two. For per-coordinate
        updates only (`pre` then `shard_update`, or an `update` with no
        `pre`); the same numbers as `apply`. Empties `grads`."""
        if self.pre is not None:
            grads_in, grads = grads, self.pre(grads)
            grads_in.clear()
        update = self.update if self.pre is None else self.shard_update
        groups, size = [[]], 0
        for k, g in grads.items():
            if groups[-1] and size + g.numel() > group_numel:
                groups.append([])
                size = 0
            groups[-1].append(k)
            size += g.numel()
        old = dict(state)
        for keys in groups:
            part = {n: {k: t[k] for k in keys} if isinstance(t, dict) else t
                    for n, t in old.items()}
            upd, new = update({k: grads.pop(k) for k in keys}, part,
                              {k: params[k] for k in keys})
            for k in keys:
                params[k] = params[k] + upd[k]
            for n, t in new.items():
                if isinstance(t, dict):
                    state[n].update(t)
                else:
                    state[n] = t
        return params, state

def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def _lr_at(lr, step):
    """A schedule's f32 tensor at `step`, or the constant as a Python
    float (torch rounds it to f32 in the product, as the reference's
    f32 array)."""
    return lr(step) if callable(lr) else lr


def cosine_schedule(peak, total_steps, warmup=0, floor=0.0):
    def sched(step):
        step = step.to(torch.float32)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                        0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return sched


def _step0(params):
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr, momentum: float = 0.0):
    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": _step0(params), "mu": mu}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            return tree_map(lambda m: -lr_t * m, mu), {"step": step,
                                                       "mu": mu}
        return tree_map(lambda g: -lr_t * g, grads), {"step": step,
                                                      "mu": None}

    return Optimizer(init, update)


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
          moment_dtype=torch.float32):
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                  device=p.device)
        return {"step": _step0(params), "m": tree_map(z, params),
                "v": tree_map(z, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(moment_dtype),
                     state["m"], grads)
        v = tree_map(lambda v_, g: (b2 * v_ + (1 - b2)
                                    * torch.square(g.to(moment_dtype))),
                     state["v"], grads)
        # the reference raises b1 to the step as f32 (optimizers.py:94-95)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)

        def upd(m_, v_, p):
            mhat = m_.to(torch.float32) / bc1
            vhat = v_.to(torch.float32) / bc2
            u = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            return (-lr_t * u).to(p.dtype)

        return tree_map(upd, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def lion(lr, b1=0.9, b2=0.99, weight_decay=0.0):
    def init(params):
        return {"step": _step0(params),
                "m": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)

        def upd(m_, g, p):
            u = torch.sign(b1 * m_ + (1 - b1) * g)
            if weight_decay:
                u = u + weight_decay * p
            return -lr_t * u

        updates = tree_map(upd, state["m"], grads, params)
        m = tree_map(lambda m_, g: b2 * m_ + (1 - b2) * g, state["m"], grads)
        return updates, {"step": step, "m": m}

    return Optimizer(init, update)


def clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    def clip(grads):
        gn = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        return tree_map(lambda g: g * scale, grads)

    # compose as pre/shard_update so a ZeRO shard wrapper can run the clip
    # on the full gradients and only the inner per-coordinate update on
    # the local slice; `update` is the composition
    inner_pre = opt.pre
    pre = clip if inner_pre is None else (lambda g: inner_pre(clip(g)))
    bare = opt.shard_update if opt.pre is not None else opt.update

    def update(grads, state, params):
        return bare(pre(grads), state, params)

    return Optimizer(opt.init, update, pre=pre, shard_update=bare)


def chain(opt: Optimizer, *wrappers) -> Optimizer:
    for w in wrappers:
        opt = w(opt)
    return opt
