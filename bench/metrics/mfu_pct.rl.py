"""The training step's model FLOP/s over the card's float32 peak, in %:
the rollout's trunk forwards, the learner's forwards and backwards (3 x
the forward, nothing recomputed) and the bootstrap forward of every
iteration of the untraced window, over that window's host time."""
from bench.counting import PEAK_FLOPS


def read(run):
    i = run.info
    if not i.get("window_s") or not i.get("window_iters"):
        return None
    return (i["iteration_flops"] * i["window_iters"] / i["window_s"]
            / PEAK_FLOPS["float32"] * 100)
