"""The survey's own workload: a small policy trunk for the DRL engine
(the port's copy of src/repro/configs/paper_drl.py)."""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="paper-drl-trunk", family="dense",
    n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab=1024, layer_pattern=(ATTN,), norm="rmsnorm",
    source="survey §3 actor/learner policy backbone",
))
