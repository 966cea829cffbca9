"""What the sharded replay service costs against the flat prioritized
buffer, on the card: the same DQN work with the replay held flat or over
a replay group of R members on one device (`DistPlan.replay(1, R)`).

    PYTHONPATH=src python experiments/replay_plan_cost.py [--rounds 5]

Two measurements, the variants in turns within one process so the host
and the card are the same for all of them:
  * one draw (`sample_with` with the kernels, a 20000-slot buffer holding
    12800 transitions, batch 64): host wall per call over 200 calls
    ending in a sync, in the order flat, R = 2, R = 4, R = 4, R = 2,
    flat per round;
  * one fit at the default DQN config (60 iterations of 32 envs x 32
    steps): wall per iteration, in the same order.
Prints one JSON line per measurement and a summary line with each
variant's median and its range, beside the card's name and power limit.
Needs a card.
"""
import argparse
import json
import statistics
import subprocess
import time

import torch

ORDER = ("flat", 2, 4, 4, 2, "flat")


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else torch.cuda.get_device_name(0)


def draw_ms(variant, calls=200):
    """Host wall per `sample_with` call of a 12800-of-20000 buffer."""
    from repro_torch.core.replay import PrioritizedReplay
    from repro_torch.core.replay_service import ShardedPrioritizedReplay
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flat = PrioritizedReplay(20000, fused=True)
    example = {"obs": torch.zeros(4, device=dev),
               "action": torch.zeros((), dtype=torch.int32, device=dev),
               "reward": torch.zeros((), device=dev),
               "next_obs": torch.zeros(4, device=dev),
               "done": torch.zeros((), dtype=torch.bool, device=dev)}
    n = 12800
    batch = {"obs": torch.randn((n, 4), generator=gen, device=dev),
             "action": torch.zeros((n,), dtype=torch.int32, device=dev),
             "reward": torch.ones((n,), device=dev),
             "next_obs": torch.randn((n, 4), generator=gen, device=dev),
             "done": torch.zeros((n,), dtype=torch.bool, device=dev)}
    prio = torch.rand((n,), generator=gen, device=dev) + 0.1
    state = flat.add_batch(flat.init(example), batch, prio)
    replay = flat
    if variant != "flat":
        replay = ShardedPrioritizedReplay(20000, "replay", variant)
        state = replay.shard_state(state)
    g = replay.noise(gen, 64)
    for _ in range(10):
        replay.sample_with(state, g, 64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        replay.sample_with(state, g, 64)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def fit_ms_per_iter(variant):
    import repro_torch.envs as envs
    from repro_torch.core.distribution import DistPlan
    from repro_torch.core.trainer import Trainer, TrainerConfig
    plan = None if variant == "flat" else DistPlan.replay(1, variant)
    cfg = TrainerConfig(algo="dqn", plan=plan)
    trainer = Trainer(envs.make("cartpole"), cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / cfg.iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("replay_plan_cost: needs a CUDA card")
    name = card()
    fit_ms_per_iter("flat")        # warm up: the kernel build, the caches
    results = {"draw_ms": {}, "fit_ms_per_iter": {}}
    for r in range(args.rounds):
        for what, fn in (("draw_ms", draw_ms),
                         ("fit_ms_per_iter", fit_ms_per_iter)):
            for variant in ORDER:
                ms = fn(variant)
                results[what].setdefault(str(variant), []).append(ms)
                print(json.dumps({"round": r, "measure": what,
                                  "variant": str(variant), "ms": ms,
                                  "card": name}), flush=True)
    summary = {what: {v: {"median": statistics.median(xs),
                          "min": min(xs), "max": max(xs), "n": len(xs)}
                      for v, xs in per.items()}
               for what, per in results.items()}
    print(json.dumps({"summary": summary, "card": name}))


if __name__ == "__main__":
    main()
