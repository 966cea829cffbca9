"""Gemma-3-1B [hf:google/gemma-3-1b-pt] (the port's copy of
src/repro/configs/gemma3_1b.py).

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, head_dim=256,
5:1 local:global attention interleave (window=512), tied embeddings.
"""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab=262144, head_dim=256,
    layer_pattern=(ATTN_LOCAL,) * 5 + (ATTN,), window=512,
    norm="rmsnorm", tie_embeddings=True, rope_theta=1_000_000.0,
    source="hf:google/gemma-3-1b-pt",
))
