"""The bf16 grouped matmul `gmm_ecd` against `torch.bmm` as the expert
count grows, on the card: a fixed cost per call (the grid's ramp and
drain) against the rate at which each streams the weights.

    PYTHONPATH=src python -m repro_torch.launch.profile_gmm_scaling

For the deepseek-moe-16b decode shapes (C = 8; d, f = 2048, 1408 and
1408, 2048) at E = 16 to 256 experts: CUDA-event ms per call over 30
calls, and the weight bytes over that time in TB/s. A line `a + b E`
through E = 128 and 256 splits each time into a fixed part a and a part
b per expert. Prints one JSON line per shape beside the card's name and
power limit. Needs a card.
"""
import json

import torch

from repro_torch.kernels.gmm.kernel import gmm_ecd
from repro_torch.launch.profiling import card

EXPERTS = (16, 32, 64, 128, 256)


def event_ms(fn, iters=30):
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    gen = torch.Generator(device="cuda").manual_seed(0)
    for C, d, f in ((8, 2048, 1408), (8, 1408, 2048)):
        rows = {}
        for E in EXPERTS:
            x = torch.randn((E, C, d), generator=gen,
                            device="cuda").bfloat16()
            w = (torch.randn((E, d, f), generator=gen, device="cuda")
                 * d ** -0.5).bfloat16()
            tb = E * d * f * 2 / 1e9  # weight GB; GB per ms is TB/s
            k, b = event_ms(lambda: gmm_ecd(x, w)), \
                event_ms(lambda: torch.bmm(x, w))
            rows[E] = {"gmm_ecd_ms": k, "bmm_ms": b,
                       "gmm_ecd_tb_per_s": tb / k, "bmm_tb_per_s": tb / b}
            del x, w
        fit = {}
        for name in ("gmm_ecd_ms", "bmm_ms"):
            per = (rows[256][name] - rows[128][name]) / 128
            fit[name] = {"fixed_ms": rows[128][name] - 128 * per,
                         "ms_per_expert": per}
        print(json.dumps({"card": card(), "shape": [C, d, f], "rows": rows,
                          "fit": fit}))


if __name__ == "__main__":
    main()
