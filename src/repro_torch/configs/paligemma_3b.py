"""PaliGemma-3B [arXiv:2407.07726] — SigLIP + Gemma, vision frontend stub
(the port's copy of src/repro/configs/paligemma_3b.py).

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216, head_dim=256.
The SigLIP tower is a stub: 256 given patch embeddings of width 1152
pass a learned projector to d_model and are prepended to the text.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=257216, head_dim=256, layer_pattern=(ATTN,), norm="rmsnorm",
    tie_embeddings=True, frontend="vision_stub", frontend_tokens=256,
    frontend_dim=1152,  # SigLIP width; the projector maps it to d_model
    rope_theta=10000.0,
    source="arXiv:2407.07726",
))
