"""DQN on GridWorld(4, 16) at tests/test_trainer.py's learning-bar config,
over a range of seeds, in the JAX package or in the PyTorch port (one of
the two per process):

    PYTHONPATH=src python experiments/dqn_gridworld_seeds.py --impl jax --seeds 0:48
    PYTHONPATH=src python experiments/dqn_gridworld_seeds.py --impl torch --device cuda --seeds 0:32

Prints one JSON line per seed (the logged returns, and the mean of the
last four: iterations 70, 80, 90, 99 at the default flags) and a summary
line: how many seeds stay under 0.8 and the mean over seeds. `--eps E`
holds ε at E for the whole run (E = 1 is a random policy), for comparing
the two packages' envs and rollouts without learning in the way.
"""
import argparse
import json
import math
import time


def fit(impl, device, seed, iters, log_every, eps):
    kw = {"warmup": 5, "eps_decay_steps": 60, "target_update": 20}
    if eps is not None:
        kw.update(eps_start=eps, eps_end=eps)
    if impl == "jax":
        from repro.core.trainer import Trainer, TrainerConfig
        from repro.envs.gridworld import GridWorld
        extra = {}
    else:
        from repro_torch.core.trainer import Trainer, TrainerConfig
        from repro_torch.envs.gridworld import GridWorld
        extra = {"device": device}
    cfg = TrainerConfig(algo="dqn", iters=iters, superstep=10, n_envs=16,
                        unroll=8, log_every=log_every, seed=seed,
                        algo_kwargs=kw)
    _, hist = Trainer(GridWorld(n=4, max_steps=16), cfg, **extra).fit()
    return [float(h["episode_return"]) for h in hist]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--device", default="cpu",
                    help="torch device (--impl torch only)")
    ap.add_argument("--seeds", default="0:16", metavar="LO:HI")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--eps", type=float, default=None,
                    help="hold ε at this value (no anneal)")
    args = ap.parse_args(argv)
    lo, hi = (int(x) for x in args.seeds.split(":"))
    last4, after = [], []
    for seed in range(lo, hi):
        t0 = time.perf_counter()
        rets = fit(args.impl, args.device, seed, args.iters, args.log_every,
                   args.eps)
        later = [r for r in rets[1:] if math.isfinite(r)]
        row = {"impl": args.impl, "device": args.device, "seed": seed,
               "wall_s": time.perf_counter() - t0,
               "mean_last_four": sum(rets[-4:]) / 4,
               "mean_after_first": sum(later) / len(later), "returns": rets}
        last4.append(row["mean_last_four"])
        after.append(row["mean_after_first"])
        print(json.dumps(row), flush=True)
    print(json.dumps({"impl": args.impl, "device": args.device,
                      "seeds": args.seeds, "eps": args.eps,
                      "under_0.8": sum(v < 0.8 for v in last4),
                      "of": len(last4),
                      "mean_over_seeds": sum(last4) / len(last4),
                      "mean_after_first_over_seeds":
                          sum(after) / len(after)}))


if __name__ == "__main__":
    main()
