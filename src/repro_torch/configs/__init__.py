"""Architecture registry of the port; `load_all()` imports every per-arch
module, in the reference's order."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN, ATTN_LOCAL, DECODE_32K, LONG_500K, MAMBA, MLA, PREFILL_32K, RWKV,
    SHAPES, SUBQUADRATIC, TRAIN_4K, ModelConfig, MoESpec, ShapeConfig,
    get_config, list_archs, register)

_ARCH_MODULES = (
    "stablelm_1_6b", "smollm_360m", "gemma3_1b", "minicpm3_4b", "rwkv6_1_6b",
    "whisper_base", "llama4_maverick_400b_a17b", "deepseek_moe_16b",
    "jamba_v0_1_52b", "paligemma_3b", "paper_drl",
)

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
