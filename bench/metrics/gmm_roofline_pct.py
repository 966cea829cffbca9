"""The experts' grouped matmuls over their roofline, in %: for every call
of `models/moe._gmm` (E, C, d) @ (E, d, f), the bound of the rows routed
to each expert (not the capacity-padded C; a routed row is a row of x
that is not all zero, read off its first column) and the weights of the
experts that have one, over the device time of the kernels launched
under those calls."""
from bench.counting import bound_s, gmm_work

SPANS = {"bench.gmm": "repro_torch.models.moe:_gmm"}


def count(state, span, args, kwargs, out):
    x, w = args[0], args[1]
    # the routed rows stay on the card until the reading: no sync here
    state.setdefault("calls", []).append(
        ((x[..., 0] != 0).sum(-1), x.shape[2], w.shape[2]))


def read(run):
    t = run.reading.device_s("bench.gmm")
    calls = run.state.get("calls")
    if not t or not calls:
        return None
    total = sum(bound_s(*gmm_work(rows.tolist(), d, f))
                for rows, d, f in calls)
    return total / t * 100
