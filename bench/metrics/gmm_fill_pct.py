"""The experts' grouped matmuls' fill, in %: of the E x C capacity rows
that each MoE layer's three grouped matmuls multiply, the share that
holds a routed assignment, sum(min(load, C)) / sum(E x C) over every MoE
layer of every traced request. Read off the program's counter
`repro_torch.moe.expert_load` (each dispatch's per-expert load, its
capacity C and its T x K assignments), which the program fills only
while a profiler records and moves to the host here, after the traced
window's closing sync; a program without the counter gives nothing."""
COUNTER = "repro_torch.moe.expert_load"


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    records = tracing.read_counters().get(COUNTER)
    if not records:
        return None
    routed = sum(min(n, r["capacity"]) for r in records for n in r["load"])
    slots = sum(len(r["load"]) * r["capacity"] for r in records)
    return routed / slots * 100
