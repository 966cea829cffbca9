"""The readings the output check's limits are set from, for one cell.

  python3 bench/calibrate.py --workload <name> --seeds 11,12,... \
      [--controls 3] [--seconds 6]

For each seed it drives the cell's own timed path at the cell's own size
and prints one JSON line of the numbers the check compares:

  * `program`: the program's output against the float32 reference, as a
    run compares it (the lower readings);
  * on the first `--controls` seeds, `tf32`: the control, the reference
    computed with TF32 products put in the program's place;
  * on those seeds, for a training cell, the planted faults: `half_batch`
    (the learner on half of the envs, the mean over the rest, in the
    reference put in the program's place) and `altered` (one reward
    altered where the env produced it). A step that returns its state
    unchanged reads 1 on `change_gap` by its definition.

An RL seed runs the fit until the checked iterations are recorded; an LM
seed runs a window of `--seconds`. Needs the card(s) the cell asks for.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def rl_seed(cell, seed, control, device="cuda"):
    from bench.drivers import rl_train
    from bench.refs import rl as ref
    r = rl_train.Run(cell, seed, 0, False, device, time.perf_counter(),
                     stop_after=rl_train.CHECKED)
    r.fit()
    r.trainer = None
    nums, want = rl_train.check(r)
    out = {"program": nums}
    if control:
        traj = r.trajs[0][0]
        args = (r.algo, r.params0, r.trajs, r.rcfg, r.hp, r.seed,
                rl_train.CHECKED)
        lp, v = ref.behaviour(r.params0, traj, r.rcfg, "tf32")
        out["tf32"] = dict(
            rl_train.learner_gaps(ref.follow(*args, precision="tf32"), want,
                                  r.params0),
            policy_gap=ref.policy_gap(r.params0, traj, lp, v, r.rcfg),
            env_gap=nums["env_gap"])
        out["half_batch"] = dict(
            rl_train.learner_gaps(ref.follow(*args, half=True), want,
                                  r.params0),
            policy_gap=nums["policy_gap"], env_gap=nums["env_gap"])
        altered = [({k: v.clone() for k, v in t.items()}, b)
                   for t, b in r.trajs]
        altered[0][0]["reward"][0, 0] += 1.0
        out["altered"] = {"env_gap": ref.env_gap(altered)}
    return out


def lm_seed(cell, seed, control, seconds, device="cuda"):
    from bench.drivers import lm_prefill
    r = lm_prefill.Run(cell, seed, device)
    r.warm()
    r.window(seconds)
    picks = r.sample()
    got = lm_prefill.gaps(r, picks)
    out = {"program": {"logit_gap_median": statistics.median(
        g for _, g in got)},
           "requests": len(r.served), "gaps": got}
    if control:
        ctl = lm_prefill.gaps(r, picks, "tf32")
        out["tf32"] = {"logit_gap_median": statistics.median(
            g for _, g in ctl)}
        out["tf32_gaps"] = ctl
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)

    import torch
    from bench import harness
    from bench.refs.transformer import set_plain_precision
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    set_plain_precision()
    cell = harness.Cell(args.workload)
    kind = cell.traffic["driver"]
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        control = n < args.controls
        if kind == "rl_train":
            out = rl_seed(cell, seed, control)
        else:
            out = lm_seed(cell, seed, control, args.seconds)
        torch.cuda.empty_cache()
        out.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
