"""Config system: model and shape configs and the architecture registry
(the port's own copy of src/repro/configs/base.py).

A model is a repeated "super-block" pattern of block kinds, which lets
heterogeneous stacks (gemma3 5:1 local:global, jamba 1 attn : 7 mamba)
run as repeats of one period. Configs are plain frozen dataclasses, so
they hash and compare.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

ATTN = "attn"            # full (global) softmax attention
ATTN_LOCAL = "attn_local"  # sliding-window attention
MLA = "mla"              # multi-head latent attention (MiniCPM3 style)
RWKV = "rwkv6"           # RWKV-6 "Finch" token-mix block (attention-free)
MAMBA = "mamba"          # Mamba selective-SSM block

SUBQUADRATIC = frozenset({ATTN_LOCAL, RWKV, MAMBA})


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

    def subquadratic(self) -> bool:
        """True if decode at very long context is feasible: no full
        attention layer (ATTN or MLA) at all, or at most a quarter of the
        layers (a hybrid whose few full-attention caches shard)."""
        kinds = set(self.pattern())
        if not {ATTN, MLA} & kinds:
            return True
        n_full = sum(1 for k in self.pattern() if k in (ATTN, MLA))
        return n_full <= self.n_layers // 4

    def param_count(self, active_only: bool = False) -> int:
        """The reference's parameter count (for MODEL_FLOPS = 6·N·D): it
        leaves out the norms' scales and biases, MLA's latent norms, the
        encoder's position table, and it approximates RWKV's low-rank
        mixers and Mamba's dt projection (rank 1) and A, D. With
        `active_only` an MoE layer counts its top-k experts only."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab * d
        for i, kind in enumerate(self.pattern()):
            # token mixer
            if kind in (ATTN, ATTN_LOCAL):
                total += (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                          + self.n_heads * hd * d)
            elif kind == MLA:
                rq = self.q_lora_rank or d
                total += d * rq + rq * self.n_heads * (hd + self.rope_head_dim)
                total += d * (self.kv_lora_rank + self.rope_head_dim)
                total += self.kv_lora_rank * self.n_heads * 2 * hd
                total += self.n_heads * hd * d
            elif kind == RWKV:
                # r,k,v,g,o projections + decay/low-rank mixers (approx)
                total += 5 * d * d + 4 * d * 64
            elif kind == MAMBA:
                di = self.ssm_expand * d
                total += d * 2 * di + di * d        # in_proj, out_proj
                total += di * self.ssm_conv          # conv
                total += di * (2 * self.ssm_state)   # B,C proj
                total += di * 2                      # dt proj (rank 1) + A,D
            # channel mixer: RWKV's built-in channel mix, MoE or SwiGLU
            if kind == RWKV:
                total += 2 * d * int(self.d_ff) + d * d  # k,v + receptance
            elif self.is_moe_layer(i):
                m = self.moe
                e = (m.top_k if active_only else m.n_experts) + m.n_shared
                total += e * 3 * d * m.d_ff + d * m.n_experts  # + router
            else:
                total += 3 * d * self.d_ff  # swiglu
        # encoder (whisper): same-width layers, full attention + MLP
        for _ in range(self.enc_layers):
            total += 4 * d * d + 3 * d * self.d_ff
        return int(total)

    def reduced(self) -> "ModelConfig":
        """The narrow variant used by default for policy trunks and CPU
        tests (the reference's `reduced`): at least one whole period of
        the pattern."""
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


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


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
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    from repro_torch import configs as _c
    _c.load_all()
    return sorted(_REGISTRY)
