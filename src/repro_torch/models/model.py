"""LanguageModel: assembles blocks into the full architecture (the port
of src/repro/models/model.py).

The reference factors the layer list into [prefix | R × super-block |
tail] — the prefix is MoE's leading dense layers, the super-block the
smallest repeating (kind, is_moe) period — and runs the R repeats as one
`lax.scan` over stacked params. The port keeps the factoring and the
names, and runs the repeats as a loop over a `ModuleList` of
super-blocks; its params are split per block ("stack/<r>/t<t>/...", see
checkpoint/convert.py), and so is its cache ("stack/<r>/t<t>/k" for an
attention block's KV cache, ".../ckv" and ".../kr" for MLA's latents,
".../S", ".../shift_tm" and ".../shift_cm" for an RWKV block's recurrent
state, ".../conv" and ".../ssm" for a Mamba block's, and ".../ek",
".../ev" for a whisper decoder block's cross keys and values).

Audio (whisper) runs an encoder over stub frame embeddings, its blocks
non-causal and its params under "enc/stack/<r>/..." (the reference
stacks them with no super-block level), and its decoder blocks
cross-attend the encoder's output; VLM (paligemma) projects stub patch
embeddings and prepends them to the tokens, so its caches grow by the
prefix and its decode positions start after it.

Execution modes: the block stack alone (`_run_seq`; the policy trunk
calls `run_blocks`), "train" (the whole sequence to (logits, aux), what
`loss` differentiates), `prefill` (emits the cache) and `decode_step`
(one token against it, updating the cache in place: an attention block
writes the token's k, v into its slot, an RWKV block overwrites its
state, and under `use_kernels` the WKV kernel writes the new S straight
into the cache's buffer). With `ModelOpts.remat` (the reference's
default) a run with no cache under grad recomputes each stack
super-block in the backward (`torch.utils.checkpoint`), as the
reference's `jax.checkpoint` around its scan body; the prefix and tail
blocks keep their activations, as there. The reference trains with
`use_kernels=False`, and so does `launch/train.py`.

The reference's ZeRO-3 list form of the stack (`_run_seq` over a list
of blocks, `_sequence_barrier`) has no counterpart: it only keeps XLA
from hoisting every block's gather ahead of the loop, and eager PyTorch
runs in program order (core/networks.py `TrunkPolicy.partition_list`).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, ModelConfig, get_config
from repro_torch.kernels.common import resolve_device
from repro_torch.models.attention import AttnOpts
from repro_torch.models.blocks import init_block, init_cache
from repro_torch.models.layers import (Params, add_param, apply_norm,
                                       apply_params, dense, embed_params,
                                       embed_tokens, init_params, normal,
                                       norm_params, unembed)
from repro_torch.tracing import spanned


def _rounds_before(name):
    """Whether the residual stream is rounded to the model's dtype before
    layer `name`: a block returns its output sum in f32, unrounded, and
    the next block of the same super-block reads it so, as the
    reference's compiled graph does inside the unrolled body of its scan
    over super-blocks; the scan's carry, the prefix and tail blocks and
    the final norm see it rounded (blocks.py `_norm1`)."""
    return not name.startswith("stack/") or name.endswith("/t0")


@dataclasses.dataclass(frozen=True)
class ModelOpts:
    dtype: str = "bfloat16"
    remat: bool = True
    use_kernels: bool = False
    block_k: int = 512
    n_q_chunks: int = 8
    moe_local_dispatch: bool = False
    # mesh axes the batch dim of activations is sharded over: when set
    # and the residual stream is a DTensor, each stack super-block's
    # input is redistributed to Shard(0) over these axes (the
    # reference's with_sharding_constraint on its scan carry); on plain
    # tensors it does nothing
    act_batch_axes: tuple = ()

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class LanguageModel(nn.Module):
    def __init__(self, cfg: ModelConfig, opts: ModelOpts = ModelOpts()):
        super().__init__()
        self.cfg = cfg
        self.opts = opts
        self.attn_opts = AttnOpts(dtype=opts.tdtype, block_k=opts.block_k,
                                  n_q_chunks=opts.n_q_chunks,
                                  use_kernels=opts.use_kernels,
                                  moe_local=opts.moe_local_dispatch)
        self.gelu_mlp = cfg.family == "audio"
        self.has_cross = cfg.enc_layers > 0
        # tokens the vision frontend prepends (the decode offset)
        self.n_prefix = (cfg.frontend_tokens if cfg.frontend == "vision_stub"
                         else 0)
        pat = cfg.pattern()
        self.specs = [(pat[i], cfg.is_moe_layer(i))
                      for i in range(cfg.n_layers)]
        self.prefix_len = cfg.moe.first_dense if cfg.moe else 0
        period = len(cfg.layer_pattern)
        if cfg.moe:
            period = math.lcm(period, cfg.moe.every)
        rem = cfg.n_layers - self.prefix_len
        self.period = period
        self.repeats = rem // period
        self.tail_len = rem - self.repeats * period
        self.stack_specs = self.specs[self.prefix_len:
                                      self.prefix_len + period]

        # each block kind's cache keys, as init_cache makes them
        self.cache_keys = {kind: tuple(init_cache(cfg, kind, 1, 1,
                                                  opts.tdtype, "meta",
                                                  self.has_cross))
                           for kind in set(pat)}

        def block(spec):
            return init_block(cfg, spec[0], spec[1], self.attn_opts,
                              self.has_cross, self.gelu_mlp)

        self.embed = embed_params(cfg)
        self.final_norm = norm_params(cfg)
        if self.prefix_len:
            self.prefix = nn.ModuleList(block(self.specs[i])
                                        for i in range(self.prefix_len))
        self.stack = nn.ModuleList(
            nn.ModuleDict({f"t{t}": block(self.stack_specs[t])
                           for t in range(self.period)})
            for _ in range(self.repeats))
        if self.tail_len:
            base = self.prefix_len + self.repeats * self.period
            self.tail = nn.ModuleList(block(self.specs[base + i])
                                      for i in range(self.tail_len))
        if cfg.enc_layers:
            self.enc = Params(pos=((cfg.enc_tokens, cfg.d_model),
                                   normal(0.02)))
            self.enc.stack = nn.ModuleList(
                init_block(cfg, ATTN, False, self.attn_opts, gelu_mlp=True,
                           causal=False) for _ in range(cfg.enc_layers))
            self.enc.final_norm = norm_params(cfg)
        if cfg.frontend == "vision_stub":
            add_param(self, "projector",
                      (cfg.frontend_dim or cfg.d_model, cfg.d_model), dense())

    def init(self, generator, device="cuda", param_dtype=None) -> dict:
        """Fresh params (flat, JAX key paths) drawn leaf by leaf on
        `generator`'s device (a CUDA generator draws on the card), the
        matrices stored in `param_dtype` (default `opts.dtype`) and the
        norm scales in f32, then placed on `device`: the card by default,
        RuntimeError without one. Training passes torch.float32: f32
        master weights whatever the compute dtype, as the reference
        stores every leaf and casts at use."""
        return init_params(self, generator, resolve_device(device),
                           param_dtype or self.opts.tdtype)

    def layers(self):
        """(cache/param key prefix, block, spec) in execution order."""
        for i, blk in enumerate(getattr(self, "prefix", ())):
            yield f"prefix/{i}", blk
        for r, sb in enumerate(self.stack):
            for t in range(self.period):
                yield f"stack/{r}/t{t}", sb[f"t{t}"]
        for i, blk in enumerate(getattr(self, "tail", ())):
            yield f"tail/{i}", blk

    def run_blocks(self, x, pos0=0, cache_capacity=0, enc_out=None):
        """The block stack over embedded inputs x: (B, S, d) (the policy
        trunk calls it directly), cross-attending `enc_out` in a model
        with an encoder. Returns (x, cache as a flat dict keyed like the
        params, the summed MoE aux loss: an f32 scalar tensor, or 0.0
        without MoE layers). With `opts.remat`, no cache and grad on,
        each stack super-block runs under `_remat_superblock`."""
        aux = 0.0
        caches = {}
        dt = x.dtype
        remat = (self.opts.remat and not cache_capacity
                 and torch.is_grad_enabled())
        for name, blk in self.layers():
            if _rounds_before(name):
                x = x.to(dt)
            if name.startswith("stack/") and name.endswith("/t0"):
                x = self._anchor_batch(x)
            if remat and name.startswith("stack/"):
                if name.endswith("/t0"):
                    x, a = self._remat_superblock(
                        self.stack[int(name.split("/")[1])], x, pos0,
                        enc_out)
                    aux = aux + a
                continue
            x, c, a = blk(x, pos0, cache_capacity, enc_out=enc_out)
            aux = aux + a
            caches.update({f"{name}/{k}": v for k, v in c.items()})
        return x.to(dt), caches, aux

    def _anchor_batch(self, x):
        """x redistributed to Shard(0) over `opts.act_batch_axes` (and
        replicated over the mesh's other axes) when it is a DTensor and
        the axes are set; x itself otherwise."""
        axes = self.opts.act_batch_axes
        if not axes:
            return x
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(x, DTensor):
            return x
        mesh = x.device_mesh
        return x.redistribute(mesh, [Shard(0) if a in axes else Replicate()
                                     for a in mesh.mesh_dim_names])

    def _remat_superblock(self, sb, x, pos0, enc_out):
        """One stack super-block under a non-reentrant checkpoint: its
        activations are recomputed in the backward. Its params go in as
        the checkpointed function's inputs, since by the recompute
        `apply_params` has put the module's meta templates back. The
        boundary is the super-block, so the residual is rounded at its
        t0 only (`_rounds_before`), as in the reference's scan body.
        Returns (x, aux)."""
        names, leaves = zip(*sb.named_parameters())

        def body(x, enc_out, *leaves):
            params = dict(zip(names, leaves))
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for t in range(self.period):
                pre = f"t{t}."
                x, _, a = functional_call(
                    sb[f"t{t}"], {k[len(pre):]: v for k, v in params.items()
                                  if k.startswith(pre)},
                    (x, pos0, 0), {"enc_out": enc_out}, strict=True)
                aux = aux + a
            return x, aux

        return checkpoint(body, x, enc_out, *leaves, use_reentrant=False)

    def encode(self, frames):
        """Whisper encoder over stub frame embeddings (B, Te, d): the
        position table, the non-causal blocks, the final norm."""
        dt = self.opts.tdtype
        x = frames.to(dt) + self.enc.pos.to(dt)
        for blk in self.enc.stack:
            x = blk(x, 0)[0].to(dt)
        return apply_norm(self.enc.final_norm, x)

    def _prepend_frontend(self, x, frontend):
        """VLM: project the patch embeddings (B, P, frontend_dim) and
        prepend them to x."""
        dt = self.opts.tdtype
        fe = torch.einsum("bpd,de->bpe", frontend.to(dt),
                          self.projector.to(dt))
        return torch.cat([fe, x], dim=1)

    def _inputs(self, tokens, frontend):
        """Embedded tokens (with the projected prefix, VLM) and the
        encoder's output (audio, else None)."""
        cfg = self.cfg
        if (cfg.enc_layers or self.n_prefix) and frontend is None:
            raise ValueError(f"{cfg.name} needs its frontend input "
                             f"({cfg.frontend}): launch/serve.stub_frontend")
        x = embed_tokens(self.embed, tokens, cfg, self.opts.tdtype)
        enc_out = self.encode(frontend) if cfg.enc_layers else None
        if self.n_prefix:
            x = self._prepend_frontend(x, frontend)
        return x, enc_out

    def forward(self, x, pos0=0, *, mode="seq", cache=None, pos=None,
                cache_capacity=0, frontend=None):
        """Runs under `apply_params` (explicit params):
          * "seq": the block stack over embedded x -> (x, cache, aux);
          * "inputs": tokens x and `frontend` -> (the embedded sequence,
            the encoder's output or None), what "prefill" runs the stack
            over;
          * "train": tokens x (and `frontend`) -> (logits (B, S, V) of
            the tokens, a VLM's prefix dropped; the summed MoE aux loss),
            the stack run with no cache;
          * "prefill": tokens x (and `frontend`) -> (last-token logits,
            cache);
          * "decode": token x (B,1) at position `pos` against `cache`
            -> (logits (B,1,V), cache updated in place)."""
        cfg = self.cfg
        if mode == "seq":
            return self.run_blocks(x, pos0, cache_capacity)
        if mode == "inputs":
            return self._inputs(x, frontend)
        if mode == "train":
            h, enc_out = self._inputs(x, frontend)
            h, _, aux = self.run_blocks(h, 0, 0, enc_out)
            h = apply_norm(self.final_norm, h)
            return unembed(self.embed, h, cfg)[:, self.n_prefix:], aux
        if mode == "prefill":
            h, enc_out = self._inputs(x, frontend)
            h, cache, _ = self.run_blocks(h, 0, cache_capacity, enc_out)
            h = apply_norm(self.final_norm, h[:, -1:])
            return unembed(self.embed, h, cfg), cache
        if mode == "decode":
            h = embed_tokens(self.embed, x, cfg, self.opts.tdtype)
            dt = h.dtype
            for name, blk in self.layers():
                if _rounds_before(name):
                    h = h.to(dt)
                h, _, _ = blk(h, cache={k: cache[f"{name}/{k}"]
                                        for k in self.cache_keys[blk.kind]},
                              pos=pos)
            h = apply_norm(self.final_norm, h.to(dt))
            return unembed(self.embed, h, cfg), cache
        raise ValueError(f"unknown mode {mode!r}")

    def _run_seq(self, params, x, pos0=0, cache_capacity=0):
        """Run the block stack on explicit params -> (x, cache, aux)."""
        return apply_params(self, params, x, pos0, mode="seq",
                            cache_capacity=cache_capacity)

    def loss(self, params, batch):
        """Next-token cross-entropy (+ MoE aux) on explicit params. batch:
        {"tokens": (B, S+1) int, optional "frontend"}. Returns (ce + aux,
        {"ce", "aux"}), the log-sum-exp and the picked logit taken in
        f32, as the reference's `loss`."""
        tokens = batch["tokens"]
        logits, aux = apply_params(self, params, tokens[:, :-1],
                                   mode="train",
                                   frontend=batch.get("frontend"))
        logits = logits.float()
        picked = logits.gather(-1, tokens[:, 1:, None].long())[..., 0]
        ce = torch.mean(torch.logsumexp(logits, dim=-1) - picked)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        return ce + aux, {"ce": ce, "aux": aux}

    @spanned("repro_torch.lm.prefill")
    def prefill(self, params, tokens, cache_capacity=None, *,
                frontend=None):
        """tokens (B,S) int -> (last-token logits (B,1,V), cache). A model
        with a frontend takes its input as `frontend`: the audio frames
        (B, enc_tokens, d_model) or the patch embeddings (B,
        frontend_tokens, frontend_dim); a VLM's cache grows by its
        `n_prefix` prepended tokens."""
        cap = cache_capacity or tokens.shape[1] + 1  # one free slot
        return apply_params(self, params, tokens, mode="prefill",
                            cache_capacity=cap + self.n_prefix,
                            frontend=frontend)

    def decode_step(self, params, token, cache, pos: int):
        """token: (B,1) int; pos: absolute position of this token (after a
        VLM's prefix). Returns (logits (B,1,V), cache), the cache updated
        in place."""
        return apply_params(self, params, token, mode="decode", cache=cache,
                            pos=pos)

    def make_cache(self, batch: int, capacity: int, device) -> dict:
        """Zero cache with the keys decode_step expects."""
        return {f"{name}/{k}": v for name, blk in self.layers()
                for k, v in init_cache(self.cfg, blk.kind, batch, capacity,
                                       self.opts.tdtype, device,
                                       self.has_cross,
                                       self.cfg.enc_tokens).items()}

    def input_specs(self, shape_cfg) -> dict:
        """Meta-tensor stand-ins for every input of the step of
        `shape_cfg`'s mode (nothing is allocated), keyed as the step's
        arguments: train {"batch": {"tokens" (B, S+1) int32, "frontend"
        where the model has one}}; prefill {"tokens" (B, S), "frontend"};
        decode {"token" (B, 1), "cache" (`make_cache` at capacity S + 1
        + the VLM prefix), "pos" () int32}. The frontend is f32: (B,
        frontend_tokens, frontend_dim) patches, (B, enc_tokens, d_model)
        audio frames."""
        cfg = self.cfg
        B, S = shape_cfg.global_batch, shape_cfg.seq_len

        def meta(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        frontend = {}
        if cfg.frontend == "vision_stub":
            frontend["frontend"] = meta(B, cfg.frontend_tokens,
                                        cfg.frontend_dim or cfg.d_model,
                                        dtype=torch.float32)
        if cfg.frontend == "audio_stub":
            frontend["frontend"] = meta(B, cfg.enc_tokens, cfg.d_model,
                                        dtype=torch.float32)
        if shape_cfg.mode == "train":
            return {"batch": {"tokens": meta(B, S + 1), **frontend}}
        if shape_cfg.mode == "prefill":
            return {"tokens": meta(B, S), **frontend}
        return {"token": meta(B, 1),
                "cache": self.make_cache(B, S + 1 + self.n_prefix, "meta"),
                "pos": meta()}


def build_model(name_or_cfg, opts: ModelOpts = ModelOpts(),
                reduced: bool = False) -> LanguageModel:
    cfg = (name_or_cfg if isinstance(name_or_cfg, ModelConfig)
           else get_config(name_or_cfg))
    if reduced:
        cfg = cfg.reduced()
    return LanguageModel(cfg, opts)
