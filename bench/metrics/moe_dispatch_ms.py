"""Device ms a prefill of the MoE layers' dispatch: the kernels launched
under `models/moe.apply_moe` (routing, the sort, the gather into the
capacity buffer, the combine) less those under its routed experts'
grouped matmuls `_gmm` and its shared experts' SwiGLU (`apply_mlp`)."""
SPANS = {"bench.moe": "repro_torch.models.moe:apply_moe",
         "bench.gmm": "repro_torch.models.moe:_gmm",
         "bench.moe_shared": "repro_torch.models.moe:apply_mlp"}


def read(run):
    n = run.info.get("traced_requests")
    moe = run.reading.device_s("bench.moe")
    if not n or not moe:
        return None
    experts = run.reading.device_s("bench.gmm", "bench.moe_shared")
    return (moe - experts) / n * 1e3
