"""Per-layer block: GQA token mixer + dense SwiGLU channel mixer,
pre-norm residual (the ATTN case of src/repro/models/blocks.py)."""
from __future__ import annotations

from torch import nn

from repro_torch.configs.base import ATTN
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, mlp_params,
                                       norm_params)


class Block(nn.Module):
    """Parameter template of one block (norm1, mixer, norm2, ffn, as the
    reference names them); `forward` is `apply_block_seq`."""

    def __init__(self, cfg, kind: str, is_moe: bool, opts: attn.AttnOpts):
        super().__init__()
        if kind != ATTN or is_moe:
            raise attn._not_ported(f"block kind {kind!r} (moe={is_moe})")
        self.cfg, self.kind, self.opts = cfg, kind, opts
        self.norm1 = norm_params(cfg)
        self.mixer = attn.attn_params(cfg, kind)
        self.norm2 = norm_params(cfg)
        self.ffn = mlp_params(cfg)

    def forward(self, x, pos0=0):
        return apply_block_seq(self.cfg, self, self.kind, False, x, pos0,
                               self.opts)


def init_block(cfg, kind: str, is_moe: bool, opts: attn.AttnOpts) -> Block:
    return Block(cfg, kind, is_moe, opts)


def apply_block_seq(cfg, p, kind, is_moe, x, pos0, opts):
    """Train / serve path of one block: x + mixer(norm1(x)), then
    + ffn(norm2(·))."""
    h = apply_norm(p.norm1, x)
    x = x + attn.gqa_seq(cfg, p.mixer, h, pos0, kind, opts)
    h2 = apply_norm(p.norm2, x)
    return x + apply_mlp(p.ffn, h2)
