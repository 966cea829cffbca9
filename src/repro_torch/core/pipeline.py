"""Decoupled actor–learner pipeline: the trajectory queue between the
rollout producer and the learner consumer (the port of
src/repro/core/pipeline.py; survey §2 learning-system architectures, the
Gorila/Ape-X actor/learner split).

A fixed-capacity ring of trajectory trees plus head/tail counters joins a
producer to a consumer in the Trainer's ``pipeline=`` mode. Each data
position holds its own queue. The reference's total semantics hold:

  * `queue_push` on a full queue refuses: it returns ``ok=False`` and the
    queue unchanged, never overwriting an item (backpressure);
  * `queue_pop` on an empty queue returns the stale head slot with
    ``ok=False`` and moves nothing (zeros before any push reached it);
  * the counters only grow, slot = counter % capacity, so
    ``size = tail - head`` needs no emptiness flag;
  * a capacity below 1 raises.

Two choices differ from the reference, because the loop here is eager:

  * **Counters on the host.** `head` and `tail` are Python ints and `ok`
    a Python bool: the slot index must be known to the host, and a
    device counter would cost a sync every tick.
  * **Slots hold references.** A push puts the pushed tree itself in the
    slot, and every op returns a new queue dict with its own slot list,
    so nothing is copied and nothing is written in place. At depth 1 the
    one slot is popped, then refilled by the push before the popped item
    is consumed; an in-place write would hand the consumer the new
    trajectory instead of the one produced a tick earlier.
"""
from __future__ import annotations

import torch

from repro_torch.core.positions import tree_map


def queue_capacity(q) -> int:
    """The ring's capacity (its number of slots)."""
    return len(q["buf"])


def queue_size(q) -> int:
    """The number of items queued (0 <= size <= capacity)."""
    return q["tail"] - q["head"]


def queue_init(item, capacity: int):
    """An empty queue for items shaped like `item`: every slot starts as
    zeros shaped like it (one zero tree, shared by the slots, never
    written); head and tail start at 0."""
    if capacity < 1:
        raise ValueError(f"queue capacity must be >= 1, got {capacity}")
    zero = tree_map(torch.zeros_like, item)
    return {"buf": [zero] * capacity, "head": 0, "tail": 0}


def queue_push(q, item):
    """Append `item` at the tail: returns ``(queue, ok)``. On a full
    queue ``ok`` is False and the queue comes back unchanged."""
    cap = queue_capacity(q)
    if queue_size(q) >= cap:
        return q, False
    buf = list(q["buf"])
    buf[q["tail"] % cap] = item
    return {"buf": buf, "head": q["head"], "tail": q["tail"] + 1}, True


def queue_pop(q):
    """Remove the oldest item: returns ``(queue, item, ok)``. On an empty
    queue ``ok`` is False, the queue comes back unchanged and `item` is
    the stale head slot."""
    item = q["buf"][q["head"] % queue_capacity(q)]
    if queue_size(q) <= 0:
        return q, item, False
    return {"buf": q["buf"], "head": q["head"] + 1, "tail": q["tail"]}, \
        item, True
