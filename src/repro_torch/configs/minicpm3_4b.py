"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] — MLA, multi-head latent
attention (the port's copy of src/repro/configs/minicpm3_4b.py).

62L d_model=2560 40H d_ff=6400 vocab=73448. MLA with q_lora_rank=768,
kv_lora_rank=256, qk_nope_head_dim=64 (head_dim), qk_rope_head_dim=32:
its decode cache holds the 256 + 32 latent of each token.
"""
from repro_torch.configs.base import MLA, ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab=73448, head_dim=64,
    layer_pattern=(MLA,), q_lora_rank=768, kv_lora_rank=256,
    rope_head_dim=32, norm="rmsnorm", rope_theta=10000.0,
    source="hf:openbmb/MiniCPM3-4B",
))
