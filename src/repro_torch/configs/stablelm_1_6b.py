"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b] (the port's copy of
src/repro/configs/stablelm_1_6b.py).

24L d_model=2048 32H (kv=32, i.e. MHA) d_ff=5632 vocab=100352. Dense
decoder, LayerNorm, rotary over the whole head dim (the reference's
simplification of the published 25%), untied embeddings.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab=100352, layer_pattern=(ATTN,), norm="layernorm",
    rope_theta=10000.0,
    source="hf:stabilityai/stablelm-2-1_6b",
))
