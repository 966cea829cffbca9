"""Jamba-v0.1 52B [arXiv:2403.19887] — Mamba + attention 7:1, MoE (the
port's copy of src/repro/configs/jamba_v0_1_52b.py).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; MoE of 16
experts, top-2, on every other layer. Each 8-layer super-block has one
attention layer and seven Mamba layers.
"""
from repro_torch.configs.base import (ATTN, MAMBA, ModelConfig, MoESpec,
                                      register)

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536, head_dim=128,
    layer_pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    ssm_state=16, ssm_conv=4, ssm_expand=2, norm="rmsnorm",
    moe=MoESpec(n_experts=16, top_k=2, d_ff=14336, n_shared=0, every=2),
    source="arXiv:2403.19887",
))
