"""Whisper-base [arXiv:2212.04356] — encoder-decoder, frontend stub (the
port's copy of src/repro/configs/whisper_base.py).

6L encoder + 6L decoder, d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
The mel-spectrogram and conv feature extractor are a stub: the encoder
runs over 1500 given frame embeddings (B, 1500, 512); the decoder has
self- and cross-attention and a GELU MLP.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51865, layer_pattern=(ATTN,), norm="layernorm",
    enc_layers=6, enc_tokens=1500, frontend="audio_stub",
    source="arXiv:2212.04356",
))
