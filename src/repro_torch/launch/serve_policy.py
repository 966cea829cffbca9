"""Policy-serving launcher: offered-load benchmark over the
repro_torch.core.serving engine (the port of
src/repro/launch/serve_policy.py).

  PYTHONPATH=src python -m repro_torch.launch.serve_policy --algo ppo \
      --env cartpole --load 500,2000 --buckets "1,4,16;16" --quick

Publishes what the chosen algorithm's `actor_policy` serves its rollout
(the MLP policy; for dqn the Q-network and its annealed ε), trained
in-process for --train-iters Trainer iterations, freshly initialized from
--seed with --train-iters 0, or restored from a reference Trainer archive
with --ckpt (its `.ring/` slot 0, and for dqn ε from its `.steps`), into
a versioned ParamStore, then replays an open-loop arrival process
at each offered load (requests/second) against each bucket
configuration: requests are admitted FIFO, padded to the smallest
fitting bucket (one program per bucket, pinned flat), and hot-swapped
onto fresh params halfway through every cell. Latency is charged from
the *scheduled* arrival. Writes the cells as a repro-bench/v1 record,
BENCH_torch_serve.json, to --out (the repo root by default;
launch/bench_record.py), and prints one JSON summary line.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

ALGOS = ("a3c", "dqn", "impala", "ppo")
HIDDEN = (64, 64)  # the algorithms' default policy widths


def parse_buckets(spec: str):
    """Bucket grammar: semicolon-separated configurations, each a
    comma-separated strictly increasing list of positive micro-batch
    sizes — e.g. "1,4,16;8,32" is two configurations."""
    configs = []
    for part in spec.split(";"):
        if not part.strip():
            raise ValueError(f"empty bucket configuration in {spec!r}")
        try:
            cfg_b = tuple(int(b) for b in part.split(","))
        except ValueError:
            raise ValueError(f"bad bucket configuration {part!r}: "
                             f"expected comma-separated integers") \
                from None
        if any(b <= 0 for b in cfg_b) or \
                any(b <= a for a, b in zip(cfg_b, cfg_b[1:])):
            raise ValueError(
                f"bad bucket configuration {part!r}: sizes must be "
                f"positive and strictly increasing")
        configs.append(cfg_b)
    return configs


def parse_loads(spec: str):
    try:
        loads = tuple(float(x) for x in spec.split(","))
    except ValueError:
        raise ValueError(f"bad --load {spec!r}: expected "
                         f"comma-separated requests/second") from None
    if not loads or any(x <= 0 for x in loads):
        raise ValueError(f"offered loads must be positive, got {spec!r}")
    return loads


def run_offered_load(engine, obs_rows, load_rps, n, swap_params=None):
    """Open-loop load replay: request i arrives at start + i/load_rps;
    the engine serves as fast as it can, sleeping only when the queue is
    empty and the next arrival is in the future. Latency = completion -
    scheduled arrival. Halfway through, `swap_params` (if given) is
    hot-swapped in."""
    start = time.perf_counter() + 0.002
    arrivals = [start + i / load_rps for i in range(n)]
    submitted, swapped = 0, False
    lats, versions = [], set()
    last_done = start
    while len(lats) < n:
        now = time.perf_counter()
        while submitted < n and arrivals[submitted] <= now:
            engine.submit(obs_rows[submitted % len(obs_rows)],
                          arrival=arrivals[submitted])
            submitted += 1
        if not len(engine.batcher):
            time.sleep(max(0.0,
                           arrivals[submitted] - time.perf_counter()))
            continue
        # halfway, or before the last dispatch when a slow host serves
        # the second half in one step: old and new params both answer
        if swap_params is not None and not swapped and lats and (
                len(lats) >= n // 2 or submitted == n):
            engine.store.publish(swap_params)
            swapped = True
        for r in engine.step():
            lats.append(r["latency_s"])
            versions.add(r["version"])
        last_done = time.perf_counter()
    lat_ms = np.asarray(lats) * 1e3
    return {"p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "throughput_rps": n / (last_done - start),
            "offered_rps": load_rps, "n": n,
            "hot_swaps": int(swapped), "versions": len(versions)}


def build_parser():
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve_policy",
        description="Batched low-latency policy serving: offered-load "
                    "p50/p99 over repro_torch.core.serving.")
    ap.add_argument("--algo", default="ppo", choices=ALGOS)
    ap.add_argument("--env", default="cartpole", metavar="ENV",
                    help="registered environment (repro_torch.envs)")
    ap.add_argument("--load", default="300,1200", metavar="RPS,RPS,...",
                    help="offered loads in requests/second; one cell per "
                         "load x bucket-config")
    ap.add_argument("--buckets", default="1,4,16;8,32",
                    metavar="B,B;B,...",
                    help="bucket configurations: semicolon-separated, "
                         "each an ascending comma list of micro-batch "
                         "sizes a request batch is padded to")
    ap.add_argument("--requests", type=int, default=600,
                    help="requests replayed per cell")
    ap.add_argument("--train-iters", type=int, default=20,
                    help="Trainer iterations before serving (0 = serve "
                         "the freshly initialized policy)")
    ap.add_argument("--ckpt", default=None, metavar="PATH",
                    help="serve the behaviour params of a reference "
                         "Trainer archive (.ring/ slot 0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="directory for BENCH_torch_serve.json (default: "
                         "the repo root; tests pass a temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    ap.add_argument("--quick", action="store_true",
                    help="smoke: fewer requests and iterations, "
                         "default loads 500,2000 and buckets 4,16;16")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.quick:
        if args.load == ap.get_default("load"):
            args.load = "500,2000"
        if args.buckets == ap.get_default("buckets"):
            args.buckets = "4,16;16"
        if args.requests == ap.get_default("requests"):
            args.requests = 160
        if args.train_iters == ap.get_default("train_iters"):
            args.train_iters = 4
    try:
        loads = parse_loads(args.load)
        configs = parse_buckets(args.buckets)
    except ValueError as e:
        ap.error(str(e))
    if args.train_iters < 0:
        ap.error(f"--train-iters {args.train_iters}: the Trainer "
                 f"iterations must be 0 or more")

    import repro_torch.envs as envs
    from repro_torch.core import agent as agent_api
    from repro_torch.core.serving import ParamStore, ServeEngine
    from repro_torch.core.trainer import Trainer, TrainerConfig
    from repro_torch.kernels.common import resolve_device
    from repro_torch.launch.bench_record import write_bench_json

    if args.env not in envs.available():
        ap.error(f"--env {args.env} not registered; available: "
                 f"{envs.available()}")
    device = resolve_device(args.device)
    env = envs.make(args.env)
    spec = env.spec
    t0 = time.time()
    store = ParamStore()
    if args.ckpt is None and args.train_iters > 0:
        # the reference's in-process training config
        # (repro/launch/serve_policy.py:185-188)
        trainer = Trainer(env, TrainerConfig(
            algo=args.algo, iters=args.train_iters,
            superstep=min(4, args.train_iters), n_envs=8, unroll=16,
            seed=args.seed, log_every=args.train_iters), device=device)
        state, _ = trainer.fit()
        policy = trainer.agent.policy
        store.publish_from_state(trainer.agent, state)
        source = "trained-in-process"
    else:
        # the agent the reference's one-iteration Trainer config builds
        agent = agent_api.make(args.algo, env=env, ring_size=1,
                               total_iters=max(args.train_iters, 1),
                               device=device)
        policy = agent.policy
        if args.ckpt is not None:
            store.load_checkpoint(args.ckpt, agent)
            source = "checkpoint"
        else:
            store.publish_from_state(agent, agent.init(
                torch.Generator().manual_seed(args.seed)))
            source = "fresh-init"
    train_s = time.time() - t0 if source == "trained-in-process" else 0.0
    # the hot-swap payload: same shapes (template-validated), fresh
    # values — published mid-cell
    _, base_params = store.get()
    swap_params = {k: v * (1 + 1e-3) if v.is_floating_point() else v
                   for k, v in base_params.items()}
    obs_rows = spec.observation.sample(
        torch.Generator().manual_seed(args.seed + 1),
        min(args.requests, 256)).numpy()

    rows, cells = [], []
    warmup_compiles = total_compiles = hot_swaps = 0
    for cfg_b in configs:
        engine = ServeEngine(policy, spec.observation, buckets=cfg_b,
                             store=store, seed=args.seed, device=device)
        warmup_compiles += engine.warmup()
        tag = "-".join(str(b) for b in cfg_b)
        for load in loads:
            cell = run_offered_load(engine, obs_rows, load, args.requests,
                                    swap_params=swap_params)
            hot_swaps += cell["hot_swaps"]
            cells.append(dict(cell, buckets=tag))
            rows.append((
                f"serve/{args.algo}/b{tag}/load{load:g}",
                cell["p50_ms"] * 1e3,
                f"p50_ms={cell['p50_ms']:.3f};"
                f"p99_ms={cell['p99_ms']:.3f};"
                f"throughput_rps={cell['throughput_rps']:.1f};"
                f"offered_rps={load:g};n={cell['n']};"
                f"hot_swaps={cell['hot_swaps']};"
                f"versions={cell['versions']}"))
        total_compiles += engine.compile_count
    recompiles = total_compiles - warmup_compiles
    rows.append((
        "serve/compile_flat", None,
        f"warmup_compiles={warmup_compiles};"
        f"recompiles_after_warmup={recompiles};"
        f"hot_swaps={hot_swaps};bucket_configs={len(configs)};"
        f"loads={len(loads)}"))
    path = write_bench_json(
        "serve", rows, device, out_dir=args.out, algo=args.algo,
        env=args.env, loads=list(loads),
        bucket_configs=[list(c) for c in configs],
        requests_per_cell=args.requests, quick=args.quick,
        train_iters=args.train_iters, source=source)
    print(json.dumps({
        "algo": args.algo, "env": args.env, "loads": list(loads),
        "bucket_configs": [list(c) for c in configs],
        "requests_per_cell": args.requests,
        "param_version": store.version,
        "warmup_compiles": warmup_compiles,
        "recompiles_after_warmup": recompiles,
        "hot_swaps": hot_swaps, "train_s": round(train_s, 1),
        "source": source, "bench": os.path.basename(path),
        "device": str(device), "cells": cells}))


if __name__ == "__main__":
    main()
