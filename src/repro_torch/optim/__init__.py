from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, sgd, lion, clip_by_global_norm, chain,
    cosine_schedule, global_norm)
