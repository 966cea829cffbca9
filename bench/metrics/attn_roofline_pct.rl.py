"""The policy trunk's attention over its roofline, in %: the bound of
every call (the short-span f32 forward, with each row's log-sum-exp in
the learner, and its backward: operations at the float32 peak or bytes
at the HBM rate, whichever is larger) over the device time of the
kernels launched under those calls."""
import torch

from bench.counting import attention_call_bound

SPANS = {"bench.attn": "repro_torch.models.attention:core_attention",
         "bench.attn_bwd":
         "repro_torch.kernels.flash_attention.ops:flash_attention_bwd"}


def count(state, span, args, kwargs, out):
    grad = torch.is_grad_enabled() and args[0].requires_grad
    state["bound_s"] = state.get("bound_s", 0.0) + attention_call_bound(
        span, args, kwargs, grad)


def read(run):
    t = run.reading.device_s("bench.attn", "bench.attn_bwd")
    if not t or "bound_s" not in run.state:
        return None
    return run.state["bound_s"] / t * 100
