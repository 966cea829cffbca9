"""LanguageModel: assembles blocks into the full architecture.

The reference factors the layer list into [prefix | R × super-block |
tail] and runs the R repeats as one `lax.scan` over stacked params. The
port keeps the factoring and the names, and runs the repeats as a loop
over a `ModuleList` of super-blocks; its params are split per block
("stack/<r>/t<t>/...", see checkpoint/convert.py). Prefill, decode, the
encoder, frontends and the ZeRO-3 list form are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models.attention import AttnOpts, _not_ported
from repro_torch.models.blocks import init_block
from repro_torch.models.layers import (apply_params, embed_params,
                                       init_params, norm_params)


@dataclasses.dataclass(frozen=True)
class ModelOpts:
    dtype: str = "bfloat16"
    use_kernels: bool = False
    block_k: int = 512
    n_q_chunks: int = 8

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class LanguageModel(nn.Module):
    def __init__(self, cfg: ModelConfig, opts: ModelOpts = ModelOpts()):
        super().__init__()
        if cfg.enc_layers or cfg.frontend != "none" or cfg.moe is not None:
            raise _not_ported(f"{cfg.name} (encoder, frontend or MoE)")
        self.cfg = cfg
        self.opts = opts
        self.attn_opts = AttnOpts(dtype=opts.tdtype, block_k=opts.block_k,
                                  n_q_chunks=opts.n_q_chunks,
                                  use_kernels=opts.use_kernels)
        pat = cfg.pattern()
        self.specs = [(pat[i], cfg.is_moe_layer(i))
                      for i in range(cfg.n_layers)]
        self.period = len(cfg.layer_pattern)
        self.repeats = cfg.n_layers // self.period
        self.tail_len = cfg.n_layers - self.repeats * self.period
        self.stack_specs = self.specs[:self.period]

        def block(spec):
            return init_block(cfg, spec[0], spec[1], self.attn_opts)

        self.embed = embed_params(cfg)
        self.final_norm = norm_params(cfg)
        self.stack = nn.ModuleList(
            nn.ModuleDict({f"t{t}": block(self.stack_specs[t])
                           for t in range(self.period)})
            for _ in range(self.repeats))
        if self.tail_len:
            base = self.repeats * self.period
            self.tail = nn.ModuleList(block(self.specs[base + i])
                                      for i in range(self.tail_len))

    def init(self, generator, device="cpu") -> dict:
        """Fresh params (flat, JAX key paths) from a torch.Generator."""
        return init_params(self, generator, device)

    def forward(self, x, pos0=0):
        """The block stack over embedded inputs x: (B, S, d)."""
        for sb in self.stack:
            for t in range(self.period):
                x = sb[f"t{t}"](x, pos0)
        for blk in getattr(self, "tail", ()):
            x = blk(x, pos0)
        return x

    def _run_seq(self, params, x, pos0=0):
        """Run the block stack on explicit params (no cache, no aux)."""
        return apply_params(self, params, x, pos0)


def build_model(name_or_cfg, opts: ModelOpts = ModelOpts(),
                reduced: bool = False) -> LanguageModel:
    cfg = (name_or_cfg if isinstance(name_or_cfg, ModelConfig)
           else get_config(name_or_cfg))
    if reduced:
        cfg = cfg.reduced()
    return LanguageModel(cfg, opts)
