"""Policy serving subsystem: batched low-latency inference for live
traffic (the port of src/repro/core/serving.py).

  * **`ServeEngine`** — one micro-batch "program" per bucket size: a
    pinned host staging buffer and its device twin, built once
    (`compile_count` counts them, and stays flat after `warmup()`). A
    dispatch packs the padded observation rows and each request's
    sampling noise into the staging buffer, makes ONE host→device copy,
    and evaluates `policy.sample_value` on the current params. A
    request's noise is a pure function of (engine seed, request id)
    (networks.request_noise), so a response depends only on (seed, id,
    params) — never on which other requests shared the micro-batch.
    Within a fixed bucket the padded rows are bitwise-inert.

  * **`RequestBatcher`** — host-side FIFO admission queue. Requests are
    never dropped and never reordered; anything beyond the micro-batch
    cap waits for the next dispatch.

  * **Bucketed micro-batching** — a batch of B live requests is padded
    to the smallest registered bucket >= B (`bucket_for`).

  * **`ParamStore`** — versioned param hot-swap. Params are inputs to
    every dispatch; `publish` validates new params against the first
    published template (same keys, shapes, dtypes) and raises on drift.
    Versions are monotonic; a dispatch reads `(version, params)` once,
    so every response is tagged with the version that produced it.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


# --------------------------------------------------------- param store
class ParamStore:
    """Versioned behavior-param store for hot-swap without a rebuild.

    The first `publish` fixes the template (keys + shapes/dtypes); every
    later publish must match it exactly, so a swap only ever changes
    tensor contents. `get()` hands out `(version, params)` as a snapshot:
    publishing never mutates previously handed-out tensors, so in-flight
    batches finish on the version they started with."""

    def __init__(self):
        self._version = 0
        self._params = None
        self._template = None   # {key: (shape, dtype)}

    @property
    def version(self) -> int:
        """Monotonic version of the latest published params (0 = none)."""
        return self._version

    @staticmethod
    def _signature(params):
        return {k: (tuple(v.shape), v.dtype) for k, v in params.items()}

    def publish(self, params) -> int:
        """Swap in new flat params; returns the new version. Raises
        ValueError naming the offending leaf on template drift."""
        params = {k: torch.as_tensor(v) for k, v in params.items()}
        sig = self._signature(params)
        if self._template is None:
            self._template = sig
        else:
            if sorted(sig) != sorted(self._template):
                raise ValueError(
                    f"hot-swap rejected: params treedef {sorted(sig)} does "
                    f"not match the published template "
                    f"{sorted(self._template)}")
            for key, (shape, dtype) in sig.items():
                ts, td = self._template[key]
                if (shape, dtype) != (ts, td):
                    raise ValueError(
                        f"hot-swap rejected: leaf {key!r} is {shape}/"
                        f"{dtype}, template has {ts}/{td} — shape/dtype "
                        f"drift would force a recompile")
        self._version += 1
        self._params = params
        return self._version

    def publish_from_state(self, agent, state, delay: int = 0) -> int:
        """Publish what `agent.actor_policy(state, delay)` serves the
        rollout: the live actor-param ring view of a Trainer state. A
        ZeRO-3 wrapper's host-layout state goes through its `host_state`
        first, so the published tree is the plan-independent one."""
        state = getattr(agent, "host_state", lambda s: s)(state)
        return self.publish(agent.actor_policy(state, delay))

    def load_checkpoint(self, path, agent, example_state=None,
                        delay: int = 0) -> int:
        """Restore a Trainer archive (either package's npz TrainState) and
        publish its actor-policy view, `agent.actor_policy(state, delay)`
        (for DQN that includes the annealed `eps`). The agent must be
        built with the config (ring_size etc.) that produced the archive.
        The state goes to `example_state`'s device when one is given,
        else to the agent's policy device. Archives hold the
        plan-independent tree form, so a ZeRO-3 wrapper serves one
        through its inner agent, at any shard count."""
        from repro_torch.checkpoint.ckpt import load_train_state
        device = (example_state.steps.device if example_state is not None
                  else agent.policy.device)
        state = load_train_state(path, device)
        return self.publish_from_state(agent, state, delay)

    def get(self):
        """-> (version, params) snapshot of the latest publish."""
        if self._params is None:
            raise RuntimeError("ParamStore is empty: publish params "
                               "(publish / publish_from_state / "
                               "load_checkpoint) before serving")
        return self._version, self._params


# ----------------------------------------------------------- batching
def validate_buckets(buckets) -> Tuple[int, ...]:
    """Normalize/validate a bucket grammar: a strictly increasing tuple
    of positive micro-batch sizes. The largest bucket is the dispatch
    cap. Raises ValueError naming the offending entry."""
    buckets = tuple(int(b) for b in buckets)
    if not buckets:
        raise ValueError("empty bucket set: serving needs at least one "
                         "micro-batch size")
    for i, b in enumerate(buckets):
        if b <= 0:
            raise ValueError(f"bucket sizes must be positive, got {b}")
        if i and b <= buckets[i - 1]:
            raise ValueError(f"bucket sizes must be strictly "
                             f"increasing, got {buckets[i - 1]} "
                             f"before {b}")
    return buckets


def bucket_for(n: int, buckets) -> int:
    """Smallest registered bucket >= n. `n` above the largest bucket is
    a caller error — the batcher caps takes at max(buckets)."""
    if n <= 0:
        raise ValueError(f"cannot bucket an empty batch (n={n})")
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket "
                     f"{buckets[-1]}; take() must cap at it")


class RequestBatcher:
    """Host-side FIFO admission queue for asynchronous requests.

    `submit` assigns a monotonically increasing request id and records
    the arrival time (wall-clock by default; load generators pass their
    scheduled arrival so queueing delay is charged to latency). `take`
    pops the oldest <= `max_n` admissible requests — strictly FIFO,
    never dropping."""

    def __init__(self):
        self._queue = collections.deque()
        self._next_id = 0

    def __len__(self) -> int:
        return len(self._queue)

    def submit(self, obs, arrival: Optional[float] = None) -> int:
        rid = self._next_id
        self._next_id += 1
        self._queue.append(
            {"id": rid, "obs": obs,
             "arrival": time.perf_counter() if arrival is None
             else arrival})
        return rid

    def next_arrival(self) -> Optional[float]:
        """Arrival time of the oldest queued request (None if empty)."""
        return self._queue[0]["arrival"] if self._queue else None

    def take(self, max_n: int, now: Optional[float] = None) -> List[dict]:
        """Pop up to `max_n` requests in FIFO order. With `now`, only
        requests that have arrived (arrival <= now) are admissible, and
        a not-yet-arrived head blocks everything behind it."""
        out = []
        while self._queue and len(out) < max_n:
            if now is not None and self._queue[0]["arrival"] > now:
                break
            out.append(self._queue.popleft())
        return out


# ------------------------------------------------------------- engine
class _BucketProgram:
    """The per-bucket staging buffers: observation columns then noise
    columns, float32, one row per slot of the bucket."""

    def __init__(self, bucket: int, obs_width: int, noise_width: int,
                 device: torch.device):
        width = obs_width + noise_width
        self.obs_width = obs_width
        self.host = torch.zeros((bucket, width), dtype=torch.float32,
                                pin_memory=device.type == "cuda")
        self.dev = torch.empty((bucket, width), dtype=torch.float32,
                               device=device)


class ServeEngine:
    """Batched low-latency inference driver.

    `policy` is a port policy (`sample_value`, `request_noise`),
    `obs_space` the env's observation Space (padding template), `store`
    the ParamStore the engine reads at every dispatch. Runs on `device`
    (default the card; raises if there is none)."""

    def __init__(self, policy, obs_space, buckets=(1, 4, 16),
                 store: Optional[ParamStore] = None, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.policy = policy
        self.obs_space = obs_space
        self.buckets = validate_buckets(buckets)
        self.store = ParamStore() if store is None else store
        self.batcher = RequestBatcher()
        self.results: Dict[int, dict] = {}
        self.seed = seed
        self._programs: Dict[int, _BucketProgram] = {}
        self._served = 0
        self._batches = 0

    @classmethod
    def for_agent(cls, agent, env, **kw):
        """Engine for a registered Agent: its rollout policy and the env's
        observation spec. Publish params separately
        (`store.publish_from_state(agent, state)`)."""
        return cls(agent.policy, env.spec.observation, **kw)

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    @property
    def compile_count(self) -> int:
        """Number of per-bucket programs built so far; flat under live
        traffic, batch size variation and param hot-swap once `warmup()`
        has run."""
        return len(self._programs)

    @property
    def stats(self) -> Dict[str, int]:
        return {"served": self._served, "batches": self._batches}

    def _program(self, bucket: int) -> _BucketProgram:
        if bucket not in self._programs:
            self._programs[bucket] = _BucketProgram(
                bucket, self.obs_space.size, self.policy.noise_dim,
                self.device)
        return self._programs[bucket]

    def eval_bucket(self, obs_rows, ids, bucket: int, params=None):
        """Run the bucket's program on explicit rows/ids (padded to
        `bucket`), returning device tensors `(action, logp, value)` for
        the first len(obs_rows) rows. This IS what `step()` dispatches —
        the bucket-parity tests use it as the per-request oracle."""
        if params is None:
            _, params = self.store.get()
        n = len(obs_rows)
        if not (0 < n <= bucket):
            raise ValueError(f"{n} rows do not fit bucket {bucket}")
        prog = self._program(bucket)
        pad_ids = np.full((bucket,), -1, np.int64)
        pad_ids[:n] = np.asarray(ids, np.int64)
        host = prog.host.numpy()
        host[:, :prog.obs_width] = 0.0
        for j, r in enumerate(obs_rows):
            host[j, :prog.obs_width] = np.asarray(r, np.float32).reshape(-1)
        host[:, prog.obs_width:] = self.policy.request_noise(self.seed,
                                                             pad_ids)
        prog.dev.copy_(prog.host)  # the one host->device copy
        obs = prog.dev[:, :prog.obs_width].reshape(
            (bucket,) + tuple(self.obs_space.shape)).to(self.obs_space.dtype)
        noise = prog.dev[:, prog.obs_width:]
        with torch.inference_mode():
            action, logp, value = self.policy.sample_value(params, obs, noise)
        self._served += n
        self._batches += 1
        return action[:n], logp[:n], value[:n]

    def warmup(self):
        """Build every bucket program once (and run it on the current
        params) so live traffic never builds one; returns the count."""
        _, params = self.store.get()
        zero = np.zeros(self.obs_space.shape, np.float32)
        for b in self.buckets:
            self.eval_bucket([zero], [0], b, params=params)
        return self.compile_count

    # -- the serving loop ----------------------------------------------
    def submit(self, obs, arrival: Optional[float] = None) -> int:
        """Enqueue one observation; returns its request id."""
        return self.batcher.submit(obs, arrival)

    def step(self, now: Optional[float] = None) -> List[dict]:
        """Admit one micro-batch (FIFO, up to the largest bucket, padded
        to the smallest fitting bucket), evaluate it on the current
        ParamStore version, and return the completed responses
        (`{"id", "action", "logp", "value", "version", "latency_s"}`,
        also recorded in `self.results`). [] when nothing is
        admissible."""
        reqs = self.batcher.take(self.max_bucket, now=now)
        if not reqs:
            return []
        version, params = self.store.get()
        bucket = bucket_for(len(reqs), self.buckets)
        action, logp, value = self.eval_bucket(
            [r["obs"] for r in reqs], [r["id"] for r in reqs], bucket,
            params=params)
        action, logp, value = (action.cpu().numpy(), logp.cpu().numpy(),
                               value.cpu().numpy())
        done = time.perf_counter()
        out = []
        for j, r in enumerate(reqs):
            resp = {"id": r["id"], "action": action[j],
                    "logp": float(logp[j]), "value": float(value[j]),
                    "version": version,
                    "latency_s": done - r["arrival"]}
            self.results[r["id"]] = resp
            out.append(resp)
        return out

    def drain(self) -> List[dict]:
        """Serve until the admission queue is empty (ignores arrival
        times — everything queued is admissible)."""
        out = []
        while len(self.batcher):
            out.extend(self.step())
        return out

    def serve(self, obs_batch) -> np.ndarray:
        """Synchronous convenience: submit a whole observation batch,
        drain it, and return the actions stacked in submission order."""
        ids = [self.submit(o) for o in obs_batch]
        self.drain()
        return np.stack([self.results[i]["action"] for i in ids])
