"""Host time of one kernel wrapper call and of its pieces, on the card:
where the CUDA-event time of a small kernel goes when the host, not the
card, sets it.

    PYTHONPATH=src python -m repro_torch.launch.profile_host_cost

Times, in us per call over 2000 calls without a sync (the host's enqueue
only), `shard_topk_c` at the replay=2 DQN path shape (R = 2 shards of
10000 slots, counts 10000 and 2800, k = 64), batched `torch.topk` over
the same scores, and the wrapper's pieces: an output allocation, the
argument checks, entering the device (`on_device`, and
`torch.cuda.device` for comparison) and reading the current stream
(`launch_stream`, and `torch.cuda.current_stream().cuda_stream`). Prints
one JSON line beside the card's name and power limit. Needs a card.
"""
import json
import time

import torch

from repro_torch.kernels.common import launch_stream, on_device
from repro_torch.kernels.replay_sample.kernel import shard_topk_c
from repro_torch.launch.profiling import card


def per_call_us(fn, n=2000):
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def main():
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    prio = torch.rand((2, 10000), generator=gen, device=dev) + 0.01
    gumbel = torch.rand((2, 10000), generator=gen, device=dev)
    nvalid = torch.tensor([10000, 2800], dtype=torch.int32, device=dev)

    def enter(ctx):
        with ctx:
            pass

    out = {
        "shard_topk_c": per_call_us(
            lambda: shard_topk_c(prio, gumbel, nvalid, 64)),
        "torch.topk": per_call_us(lambda: torch.topk(prio, 64, dim=-1)),
        "torch.empty": per_call_us(
            lambda: torch.empty((2, 2, 64), dtype=torch.int32, device=dev)),
        "checks": per_call_us(lambda: [
            (t.dtype, t.device != dev, t.is_contiguous())
            for t in (prio, gumbel, nvalid)]),
        "on_device": per_call_us(lambda: enter(on_device(dev))),
        "torch.cuda.device": per_call_us(
            lambda: enter(torch.cuda.device(dev))),
        "launch_stream": per_call_us(lambda: launch_stream(dev)),
        "torch.cuda.current_stream": per_call_us(
            lambda: torch.cuda.current_stream().cuda_stream)}
    print(json.dumps({"card": card(), "host_us_per_call": out}))


if __name__ == "__main__":
    main()
