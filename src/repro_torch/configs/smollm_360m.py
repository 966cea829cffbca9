"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-135M family] — llama-arch small
(the port's copy of src/repro/configs/smollm_360m.py).

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152. Tied embeddings,
RMSNorm, SwiGLU.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab=49152, layer_pattern=(ATTN,), norm="rmsnorm",
    tie_embeddings=True, rope_theta=10000.0,
    source="hf:HuggingFaceTB/SmolLM-135M",
))
