"""The prefill's causal attention over its roofline, in %: the bound of
every call of the f32 flash forward over long spans (operations at the
float32 peak or bytes at the HBM rate, whichever is larger) over the
device time of the kernels launched under those calls."""
from bench.counting import attention_call_bound

SPANS = {"bench.attn": "repro_torch.models.attention:core_attention"}


def count(state, span, args, kwargs, out):
    state["bound_s"] = state.get("bound_s", 0.0) + attention_call_bound(
        span, args, kwargs, False)


def read(run):
    t = run.reading.device_s("bench.attn")
    if not t or "bound_s" not in run.state:
        return None
    return run.state["bound_s"] / t * 100
