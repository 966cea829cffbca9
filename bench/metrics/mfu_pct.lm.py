"""The prefills' model FLOP/s over the card's float32 peak, in %: every
prompt token through the blocks (the experts at top k, no token dropped)
and one unembedding a request, over the untraced window's host time."""
from bench.counting import PEAK_FLOPS


def read(run):
    i = run.info
    if not i.get("window_s") or not i.get("window_flops"):
        return None
    return i["window_flops"] / i["window_s"] / PEAK_FLOPS["float32"] * 100
