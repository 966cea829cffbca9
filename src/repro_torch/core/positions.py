"""Data positions on one device: the runtime counterpart of the
reference's mesh and `shard_map` (src/repro/core/trainer.py).

A plan with W data positions (`DistPlan.sim_devices`) runs W copies of
the one-position program, one thread each, all on the Trainer's device.
Each thread keeps its own TrainState, env batch, generators and delays,
and runs the unchanged iteration (rollout, learner step, ring push). The
positions meet only inside the learner's `grad_tx` / `param_tx` hooks,
through a `PositionGroup`.

The positions take turns, in rank order: one runs at a time, up to its
next collective, where it deposits its tree and hands the turn on. The
last rank to deposit computes the collective from the rank-ordered list
and hands the turn back to rank 0; each rank then takes its entry when
its turn comes. Threads that all ran at once would gain nothing: Python
runs one thread at a time, and the card's one stream runs their work in
turn anyway. They would lose much: PyTorch lets go of the interpreter
lock around every op, so W running threads pass it back and forth on
every op (on the H100's host, four positions ran an iteration 15 times
slower than one, not 4).

The arithmetic of a collective is a pure function over a leading
(mesh...) position layout (`core/topology.py`, `DistPlan.
compile_collectives`); the group only moves trees in and out of that
layout, and every reduction runs in rank order.

No collective waits forever: every wait for the turn has a timeout, and
a rank that raises aborts the group, so the others leave their waits at
once and `run` re-raises the first error in the caller. A later
multi-card backend (one process per card, `torch.distributed`) replaces
the group and leaves the algorithms as they are.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from typing import Tuple

import torch

COLLECTIVE_TIMEOUT_S = 300.0  # longer than a first kernel build


def tree_map(fn, *trees):
    """`fn` over the tensor leaves of nested dicts, lists and tuples;
    None stays None."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    if t is None:
        return None
    return fn(*trees)


def tree_leaves(tree):
    """The tensor leaves of `tree`, in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def stack_trees(trees):
    """A list of congruent trees as one tree whose leaves carry a leading
    (len(trees),) dim."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A plan's named axes on one device: every position, at mesh
    coordinates (i0, i1, ...), lives on `device`. `shape` maps each axis
    name to its size, as a JAX mesh's does."""
    axis_names: Tuple[str, ...]
    mesh_shape: Tuple[int, ...]
    device: torch.device

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.mesh_shape))


class PositionAborted(RuntimeError):
    """Raised in a rank whose group was aborted by another rank's error
    or by a wait that timed out."""


class PositionGroup:
    """W ranks on one device that take turns and meet at collectives; see
    module doc."""

    def __init__(self, n: int, timeout: float = COLLECTIVE_TIMEOUT_S):
        self.n = n
        self.timeout = timeout
        self._cond = threading.Condition()
        self._turn = 0
        self._round = 0          # collectives completed
        self._slots = [None] * n
        self._out = None
        self._error = None
        self._aborted = False
        self._pool = None

    # ---- the turn ----------------------------------------------------
    def _wait_turn(self, rank: int) -> None:
        deadline = time.monotonic() + self.timeout
        with self._cond:
            while self._turn != rank and not self._aborted:
                left = deadline - time.monotonic()
                if left <= 0:
                    self._aborted = True
                    self._cond.notify_all()
                    raise PositionAborted(
                        f"position {rank} waited more than {self.timeout} "
                        f"s for its turn")
                self._cond.wait(left)
            if self._aborted:
                raise PositionAborted("position group aborted: another "
                                      "position failed or timed out")

    def _pass_turn(self, rank: int) -> None:
        with self._cond:
            self._turn = (rank + 1) % self.n
            self._cond.notify_all()

    # ---- collectives -------------------------------------------------
    def collective(self, rank: int, fn, tree):
        """Deposit `tree` and hand the turn on; `fn` maps the rank-ordered
        list of every rank's tree to a list of results, computed once by
        the last rank; each rank returns its entry when its turn comes
        back. Rank r reads its entry before it can deposit again, and the
        last rank computes only once every rank has deposited, so one
        output slot suffices."""
        self._slots[rank] = tree
        if rank == self.n - 1:
            try:
                self._out = fn(list(self._slots))
            except BaseException as exc:
                self.fail(exc)
                raise
            self._round += 1
            want = self._round
        else:
            want = self._round + 1
        self._pass_turn(rank)
        self._wait_turn(rank)
        if self._round != want:
            raise RuntimeError(
                f"position {rank} met a collective that a later position "
                f"finished without meeting: every position must make the "
                f"same collective calls")
        return self._out[rank]

    def hook(self, rank: int, stacked_fn, lead):
        """`stacked_fn`, a function of one tensor whose leading dims are
        the `lead` position dims (a `compile_collectives` hook), as rank
        `rank`'s hook on its own tree: every rank's leaves go through as
        one flat vector (one stack and one reduction a collective, not
        one a leaf), and come back in the tree's shapes."""
        def on_stack(trees):
            leaves = [tree_leaves(t) for t in trees]
            if len({x.dtype for x in leaves[0]}) != 1:
                raise ValueError("a collective's tree must hold one dtype")
            flat = torch.stack([torch.cat([x.reshape(-1) for x in ls])
                                for ls in leaves])
            out = stacked_fn(flat.reshape(tuple(lead) + flat.shape[1:]))
            out = out.reshape(flat.shape)
            sizes = [x.numel() for x in leaves[0]]
            res = []
            for r in range(self.n):
                parts = iter(torch.split(out[r], sizes))
                res.append(tree_map(
                    lambda x: next(parts).reshape(x.shape), trees[r]))
            return res

        return lambda tree: self.collective(rank, on_stack, tree)

    def shard_gather(self, rank: int, members):
        """Rank `rank`'s all-gather over its shard group, for a
        `ShardAxis` (core/topology.py): `members[r]` lists rank r's group
        in shard order. Each rank deposits a list of chunks and gets, for
        each, its own concatenation of its group's chunks (a replica of
        its own, as each device holds one)."""
        def on_lists(trees):
            return [[torch.cat([trees[m][e] for m in members[r]])
                     for e in range(len(trees[r]))]
                    for r in range(self.n)]

        return lambda chunks: self.collective(rank, on_lists, chunks)

    # ---- running the ranks -------------------------------------------
    def fail(self, exc) -> None:
        """Record `exc` (the first one wins) and release every waiting
        rank."""
        with self._cond:
            if self._error is None:
                self._error = exc
            self._aborted = True
            self._cond.notify_all()

    def run(self, work):
        """`work(rank)` for every rank, each in its own thread, taking
        turns from rank 0; returns their results in rank order. The first
        error any rank raised is re-raised here; a wait that timed out
        with no error raises TimeoutError."""
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                self.n, thread_name_prefix="position")

        def guarded(rank):
            try:
                self._wait_turn(rank)
                result = work(rank)
                self._pass_turn(rank)
                return result
            except BaseException as exc:
                if not isinstance(exc, PositionAborted):
                    self.fail(exc)
                raise

        self._turn = 0
        futures = [self._pool.submit(guarded, r) for r in range(self.n)]
        _, pending = concurrent.futures.wait(
            futures, return_when=concurrent.futures.FIRST_EXCEPTION)
        if pending:   # a rank failed: the others leave their waits at once
            concurrent.futures.wait(pending, timeout=self.timeout)
        if self._error is not None:
            raise self._error
        for f in futures:
            exc = f.exception(timeout=0) if f.done() else PositionAborted(
                f"a position did not finish within {self.timeout} s of "
                f"the group's abort")
            if isinstance(exc, PositionAborted):
                raise TimeoutError(str(exc)) from None
            if exc is not None:
                raise exc
        return [f.result() for f in futures]

    def close(self) -> None:
        """Let the threads go: every rank's work has returned or raised
        by now (a rank stuck past the abort is left behind, not waited
        for)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
