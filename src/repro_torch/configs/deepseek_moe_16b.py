"""DeepSeek-MoE-16B [arXiv:2401.06066] — fine-grained experts (the
port's copy of src/repro/configs/deepseek_moe_16b.py).

28L d_model=2048 16H (kv=16) vocab=102400. Layer 0 is a dense FFN
(d_ff=10944); layers 1..27 are MoE with 64 routed experts (top-6,
expert d_ff=1408) + 2 shared experts.
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoESpec, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab=102400, layer_pattern=(ATTN,), norm="rmsnorm",
    moe=MoESpec(n_experts=64, top_k=6, d_ff=1408, n_shared=2, every=1,
                first_dense=1),
    source="arXiv:2401.06066",
))
