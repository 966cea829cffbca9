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
once and `run` re-raises the first error in the caller.

Processes (`ProcessPositions`, `run_processes`): the same W positions,
one process each, rank r of a `torch.distributed` group of W, in place
of the group of threads; the algorithms stay as they are. A collective
all-gathers every rank's flat vector in rank order and applies the same
pure function to the stacked rows on every rank, each keeping its own
row: exactly what `PositionGroup.collective`'s last rank computes, so a
fit is bitwise the threaded fit (not a ring all-reduce, whose order is
the library's). The backend is explicit: `nccl` puts rank r on
`cuda:r`; `gloo` is a host transport, so a CUDA tensor goes through the
host (`.cpu()`, then back to the rank's device), and every rank may
share one card. Each wait has the group's timeout; a rank that raises
reports its error and leaves the group, the launcher then stops the
others and raises the error, naming the rank.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import threading
import time
import traceback
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


def _flat(tree):
    """`tree`'s leaves as one flat vector, and their sizes."""
    leaves = tree_leaves(tree)
    if len({x.dtype for x in leaves}) != 1:
        raise ValueError("a collective's tree must hold one dtype")
    return torch.cat([x.reshape(-1) for x in leaves]), [x.numel()
                                                        for x in leaves]


def _unflat(vec, sizes, like):
    """The inverse of `_flat`: `vec` cut into the leaves of `like`."""
    parts = iter(torch.split(vec, sizes))
    return tree_map(lambda x: next(parts).reshape(x.shape), like)


def _on_rows(stacked_fn, lead, rows):
    """`stacked_fn` over the rank-ordered (W, N) rows laid out over the
    `lead` position dims, back as (W, N)."""
    return stacked_fn(rows.reshape(tuple(lead) + rows.shape[1:])).reshape(
        rows.shape)


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
            flats = [_flat(t) for t in trees]
            out = _on_rows(stacked_fn, lead,
                           torch.stack([f for f, _ in flats]))
            return [_unflat(out[r], flats[r][1], trees[r])
                    for r in range(self.n)]

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


class RankFailed(RuntimeError):
    """Raised by `run_processes` when a rank raised or died: the message
    names the rank and holds its traceback."""


class ProcessPositions:
    """Data position `rank` of `n`, in a process of its own: one rank of
    a `torch.distributed` group, with `PositionGroup`'s collectives for
    its own rank (module doc, "Processes"). `backend` is "nccl" (a card a
    rank, `device` the rank's) or "gloo" (through the host: a CUDA tensor
    is staged with `.cpu()` and copied back to `device`). The group is
    the process's default group, initialised here from `init_method`
    with `timeout` seconds for every collective; `close` leaves it."""

    def __init__(self, rank: int, n: int, backend: str, init_method: str,
                 device, timeout: float = COLLECTIVE_TIMEOUT_S):
        import torch.distributed as dist
        self.rank, self.n, self.backend = rank, n, backend
        self.device = torch.device(device)
        self.timeout = timeout
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"backend 'nccl' needs a CUDA device, got "
                             f"{self.device}")
        dist.init_process_group(
            backend, init_method=init_method, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))

    def _own(self, rank: int) -> None:
        if rank != self.rank:
            raise ValueError(f"process of rank {self.rank} asked for rank "
                             f"{rank}'s collective")

    def all_gather(self, t):
        """Every rank's `t` (of one shape and dtype on every rank), in
        rank order, on this rank's device."""
        import torch.distributed as dist
        wire = t.contiguous() if self.backend == "nccl" else t.cpu()
        out = [torch.empty_like(wire) for _ in range(self.n)]
        dist.all_gather(out, wire)
        return [o.to(self.device) for o in out]

    def gather_objects(self, obj):
        """Every rank's picklable `obj`, in rank order (tensors in it are
        best moved to the CPU first)."""
        import torch.distributed as dist
        out = [None] * self.n
        dist.all_gather_object(out, obj)
        return out

    def hook(self, rank: int, stacked_fn, lead):
        """`PositionGroup.hook` for this process's rank: the rank-ordered
        flat vectors of every rank through `stacked_fn` on every rank,
        this rank's row back in its tree's shapes."""
        self._own(rank)

        def tx(tree):
            flat, sizes = _flat(tree)
            out = _on_rows(stacked_fn, lead, torch.stack(
                self.all_gather(flat)))
            return _unflat(out[self.rank], sizes, tree)

        return tx

    def shard_gather(self, rank: int, members):
        """`PositionGroup.shard_gather` for this process's rank: every
        rank's chunks gathered (one collective), this rank's group's
        concatenated in shard order."""
        self._own(rank)
        group = members[rank]

        def gather(chunks):
            flat, sizes = _flat(chunks)
            rows = self.all_gather(flat)
            parts = [torch.split(rows[m], sizes) for m in group]
            return [torch.cat([p[e].reshape(c.shape) for p in parts])
                    for e, c in enumerate(chunks)]

        return gather

    def close(self) -> None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def _environ(values):
    """`os.environ` with `values` set around the block: the spawned
    children inherit them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _watch_parent(pid: int) -> None:
    """Exit this process once its parent is gone: no rank outlives its
    launcher."""
    def watch():
        while os.getppid() == pid:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=watch, name="parent-watch", daemon=True).start()


def _process_main(rank, n, backend, init_method, device, timeout, threads,
                  parent, fn, args, results):
    """A rank's process: `fn(group, *args)` over its `ProcessPositions`;
    puts (rank, True, result) or (rank, False, traceback) on `results`."""
    _watch_parent(parent)
    group = None
    try:
        torch.set_num_threads(threads)
        device = torch.device(device)
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        group = ProcessPositions(rank, n, backend, init_method, device,
                                 timeout)
        # pickled here, by value: the queue's own pickler would hand
        # tensors over as shared memory that dies with this process
        results.put((rank, True, pickle.dumps(fn(group, *args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if group is not None:
            group.close()


def run_processes(fn, args=(), *, n: int, backend: str, devices,
                  timeout: float = COLLECTIVE_TIMEOUT_S, threads: int = 1,
                  deadline: float = None):
    """`fn(group, *args)` in `n` spawned processes, rank r's `group` a
    `ProcessPositions` on `devices[r]`, meeting at a `file://`
    rendezvous in a fresh temp dir; returns the results in rank order.
    Each child runs `threads` intra-op threads (and OMP_NUM_THREADS).
    The first rank that raises (or dies) stops every other and raises
    `RankFailed` naming it; past `deadline` seconds (None: no limit, each
    collective still times out after `timeout`) every child is killed
    and TimeoutError raised. No child outlives the call."""
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="positions-")
    init = "file://" + os.path.join(tmp, "rendezvous")
    # gloo's and NCCL's sockets on the loopback interface, unless set
    env = {"OMP_NUM_THREADS": str(threads),
           **{k: os.environ.get(k, "lo") for k in ("GLOO_SOCKET_IFNAME",
                                                   "NCCL_SOCKET_IFNAME")}}
    end = None if deadline is None else time.monotonic() + deadline
    procs, done = [], {}
    try:
        with _environ(env):
            for r in range(n):
                p = ctx.Process(target=_process_main, name=f"position-{r}",
                                args=(r, n, backend, init, str(devices[r]),
                                      timeout, threads, os.getpid(), fn,
                                      args, results), daemon=True)
                p.start()
                procs.append(p)
        while len(done) < n:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(n)) - set(done))} of {n} "
                        f"did not finish within {deadline} s") from None
                if not dead:
                    continue
                try:   # a rank that reported, then exited: its report
                    rank, ok, payload = results.get(timeout=2.0)
                except queue_mod.Empty:
                    raise RankFailed(
                        f"rank {dead[0]} of {n} died with exit code "
                        f"{procs[dead[0]].exitcode}") from None
            if not ok:
                raise RankFailed(f"rank {rank} of {n} failed:\n{payload}")
            done[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [done[r] for r in range(n)]
