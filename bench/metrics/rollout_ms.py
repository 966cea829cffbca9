"""Device ms an iteration of the rollout: the kernels launched under
`Trainer._produce` (the actor's trunk forwards, sampling, env steps and
resets)."""
SPANS = {"bench.produce": "repro_torch.core.trainer:Trainer._produce"}


def read(run):
    calls = run.reading.calls.get("bench.produce", 0)
    if not calls:
        return None
    return run.reading.device_s("bench.produce") / calls * 1e3
