"""Device ms an iteration of the learner: the kernels launched under
`Trainer._consume` (targets, forward, backward on autograd's thread,
clipping and the optimizer, the episode accounting)."""
SPANS = {"bench.consume": "repro_torch.core.trainer:Trainer._consume"}


def read(run):
    calls = run.reading.calls.get("bench.consume", 0)
    if not calls:
        return None
    return run.reading.device_s("bench.consume") / calls * 1e3
