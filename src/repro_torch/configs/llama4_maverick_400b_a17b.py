"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E
family] (the port's copy of
src/repro/configs/llama4_maverick_400b_a17b.py).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048; MoE of 128
experts, top-1, with one shared expert, on alternating layers (a dense
FFN on the others). The text backbone only.
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoESpec, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128, layer_pattern=(ATTN,), norm="rmsnorm",
    rope_theta=500000.0,
    moe=MoESpec(n_experts=128, top_k=1, d_ff=8192, n_shared=1, every=2),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
