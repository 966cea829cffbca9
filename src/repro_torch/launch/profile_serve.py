"""Where a serve dispatch spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--env cartpole] [--bucket 32] [--dispatches 200]

Serves the full-width `paper-drl-trunk` policy (fresh seeded init)
through ServeEngine at one fixed bucket and reports, as one JSON line:
  * `dispatch_ms`: host wall time of one full dispatch (pack, one
    host->device copy, forward, device->host copy), mean over the run;
  * `forward_ms`: CUDA-event time of the policy forward alone on the
    staged batch;
  * a torch.profiler window over `--profile-dispatches` dispatches
    (`launch/profiling.device_window`): the device's busy share (sum of
    device time over the window's wall time), the device time and the
    number of device kernels per dispatch, the flash-attention kernels'
    share of the device time, and the top kernels by device time.
Needs a card: there is no CPU mode.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.launch.profiling import card, device_window


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.profile_serve")
    ap.add_argument("--env", default="cartpole")
    ap.add_argument("--bucket", type=int, default=32)
    ap.add_argument("--dispatches", type=int, default=200)
    ap.add_argument("--profile-dispatches", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_serve measures the card; torch sees no "
                           "CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import repro_torch.envs as envs
    from repro_torch.core.networks import TrunkPolicy
    from repro_torch.core.serving import ParamStore, ServeEngine

    spec = envs.make(args.env).spec
    policy = TrunkPolicy.for_spec(spec, reduced=False)
    store = ParamStore()
    store.publish(policy.init(torch.Generator().manual_seed(0)))
    engine = ServeEngine(policy, spec.observation, buckets=(args.bucket,),
                         store=store, seed=0)
    engine.warmup()
    B = args.bucket
    rows = list(spec.observation.sample(torch.Generator().manual_seed(1),
                                        B).numpy())

    def dispatch():
        for r in rows:
            engine.submit(r)
        return engine.step()

    for _ in range(20):
        dispatch()
    t0 = time.perf_counter()
    for _ in range(args.dispatches):
        dispatch()
    dispatch_ms = (time.perf_counter() - t0) * 1e3 / args.dispatches

    _, params = store.get()
    prog = engine._program(B)
    obs = prog.dev[:, :prog.obs_width].reshape((B,) + spec.observation.shape)
    noise = prog.dev[:, prog.obs_width:]

    def forward():
        with torch.inference_mode():
            return policy.sample_value(params, obs, noise)

    for _ in range(20):
        forward()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.dispatches):
        forward()
    end.record()
    torch.cuda.synchronize()
    forward_ms = start.elapsed_time(end) / args.dispatches

    print(json.dumps({
        "card": card(), "env": args.env, "bucket": B,
        "dispatch_ms": dispatch_ms, "forward_ms": forward_ms,
        "profile": device_window(dispatch, args.profile_dispatches,
                                 share_of={"flash_attention": "flash_"}),
        "served": engine.stats["served"]}))


if __name__ == "__main__":
    main()
