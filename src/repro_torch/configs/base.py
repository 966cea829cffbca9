"""Config system: model configs and the architecture registry (the
port's own copy of the parts of src/repro/configs/base.py that the
policy trunk and the LM serving path need).

A model is a repeated "super-block" pattern of block kinds. Configs are
plain frozen dataclasses, so they hash and compare.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

ATTN = "attn"  # full (global) softmax attention
RWKV = "rwkv6"  # RWKV-6 time mix + channel mix; the other kinds wait for
#                 the LM zoo (ROADMAP queue 1, item 15)


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts FFN spec."""
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    n_shared: int = 0              # always-on shared experts (DeepSeek-MoE)
    every: int = 1                 # MoE FFN every `every` layers
    first_dense: int = 0           # leading dense layers (DeepSeek-MoE layer 0)
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    layer_pattern: Tuple[str, ...] = (ATTN,)   # repeated to cover n_layers
    window: int = 0                # sliding window of local attention
    moe: Optional[MoESpec] = None
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    enc_layers: int = 0
    enc_tokens: int = 0
    frontend: str = "none"         # none | audio_stub | vision_stub
    frontend_tokens: int = 0
    frontend_dim: int = 0
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    source: str = ""               # citation

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def pattern(self) -> Tuple[str, ...]:
        """Full per-layer block-kind list of length n_layers."""
        reps = math.ceil(self.n_layers / len(self.layer_pattern))
        return tuple((self.layer_pattern * reps)[: self.n_layers])

    def is_moe_layer(self, i: int) -> bool:
        m = self.moe
        if m is None:
            return False
        if i < m.first_dense:
            return False
        return (i - m.first_dense) % m.every == 0

    def param_count(self) -> int:
        """Parameters of the ATTN / RWKV / MoE / dense-FFN stack (the
        reference's count for those kinds; for RWKV it is the reference's
        approximation, which leaves out the low-rank mixers' true widths,
        the decay and lerp constants and the head norms)."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab * d
        for i, kind in enumerate(self.pattern()):
            if kind == RWKV:
                # r,k,v,g,o projections + decay/low-rank mixers (approx),
                # then the built-in channel mix: k, v + receptance
                total += 5 * d * d + 4 * d * 64
                total += 2 * d * int(self.d_ff) + d * d
                continue
            if kind != ATTN:
                raise NotImplementedError(f"param_count of kind {kind!r}")
            total += 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            if self.is_moe_layer(i):
                m = self.moe
                total += ((m.n_experts + m.n_shared) * 3 * d * m.d_ff
                          + d * m.n_experts)  # + router
            else:
                total += 3 * d * self.d_ff  # swiglu
        return int(total)

    def reduced(self) -> "ModelConfig":
        """The narrow variant used by default for policy trunks and CPU
        tests (the reference's `reduced`, MoE included)."""
        d = min(self.d_model, 128)
        n_heads = max(2, min(self.n_heads, 4))
        hd = max(8, d // n_heads)
        kv = 1 if self.n_kv_heads == 1 else max(1, min(self.n_kv_heads, 2))
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff=64, n_shared=min(self.moe.n_shared, 1),
                first_dense=min(self.moe.first_dense, 1))
        n_layers = max(2, len(self.layer_pattern))
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=d, n_heads=n_heads,
            n_kv_heads=kv, head_dim=hd, d_ff=128, vocab=512, moe=moe,
            q_lora_rank=min(self.q_lora_rank, 32) if self.q_lora_rank else 0,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.kv_lora_rank else 0,
            rope_head_dim=min(self.rope_head_dim, 16),
            window=min(self.window, 64) if self.window else 0,
            enc_layers=min(self.enc_layers, 2),
            enc_tokens=min(self.enc_tokens, 32) if self.enc_tokens else 0,
            frontend_tokens=min(self.frontend_tokens, 16)
            if self.frontend_tokens else 0,
        )


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from repro_torch import configs as _c
        _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; the port has "
                       f"{sorted(_REGISTRY)} (the LM zoo waits for ROADMAP "
                       f"queue 1, item 15)")
    return _REGISTRY[name]
