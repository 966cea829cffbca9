"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892] — attention-free, data-dependent
decay (the port's copy of src/repro/configs/rwkv6_1_6b.py).

24L d_model=2048 d_ff=7168 vocab=65536. 32 heads of size 64 for the WKV
state. O(1)-state decode.
"""
from repro_torch.configs.base import RWKV, ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
    vocab=65536, head_dim=64, layer_pattern=(RWKV,), norm="layernorm",
    source="arXiv:2404.05892",
))
