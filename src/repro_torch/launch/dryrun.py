"""Multi-pod dry-run: partition every (arch × shape × mesh) step over the
production mesh and extract the roofline terms (the port of
src/repro/launch/dryrun.py).

The reference lowers and compiles each step with XLA against 512 fake
host devices and reads the post-SPMD HLO. The port builds the same mesh
over a fake process group (launch/mesh.py) and runs the step once on
meta DTensors: the params, optimizer moments, batch and cache carry the
placements of launch/sharding.py, DTensor partitions every op and issues
its collectives on the local shards, and `CollectiveRecorder` counts
them. Nothing is allocated and no card is used; the fake group makes
this process a rank of that world, so run it in a process of its own.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k [--multi-pod] [--fsdp] [--param-dtype bfloat16] \\
      [--mesh-shape 4,4] [--policy pure_dp]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # 40 pairs

Results are written as JSON under experiments/dryrun_torch/. A record
keeps the reference's keys where they mean the same, with these
differences:
  * `trace_s` (the partitioned run on meta) in place of `lower_s` and
    `compile_s`;
  * `counted_flops`, the matmul and attention FLOPs of this rank's
    local ops (torch.utils.flop_counter's formulas), in place of
    `hlo_flops`; there is no `hlo_bytes`;
  * `collective_bytes_corrected` is the direct count of every collective
    (no scan: every layer runs); `collective_probe_bytes` still holds one
    stack super-block run alone under the same placements
    (`stack_probe_collectives`), and `stack_repeats` its repeats;
  * `collective_bytes_by_axis`, the result bytes per mesh axis, from
    which `collective_term_s` takes each axis at its own rate (NVLink or
    InfiniBand, `mesh.axis_bandwidth`);
  * `mem_argument_size_in_bytes` and `mem_output_size_in_bytes` are the
    local shard bytes of the step's inputs and outputs; there is no
    temp or generated-code size.
DTensor has no sharding strategy for some ops the models run, and its
strategy for others fails on these inputs: `RULE_OPS` gives each a rule
of the dry-run's own (listed with the reason), so the collectives they
cost are counted. `torch.einsum` over DTensors runs in
`partitioned_einsum`: DTensor's own decomposes it into matmuls over
flattened dims and refuses (torch 2.11) to flatten a sharded inner dim.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, get_config
from repro_torch.launch import analytic
from repro_torch.launch.comm_analysis import (CollectiveRecorder,
                                              bytes_by_axis,
                                              collective_bytes)
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, axis_bandwidth,
                                     axis_sizes, make_production_mesh,
                                     n_chips)
from repro_torch.launch.sharding import (P, batch_sharding, cache_sharding,
                                         placements, shard_params)
from repro_torch.models.layers import apply_params
from repro_torch.models.model import ModelOpts, build_model
from repro_torch.optim import adamw

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../experiments/dryrun_torch")

# per-arch memory-fit decisions: big models train with bf16 params +
# ZeRO-3 over the data axis.
ARCH_OVERRIDES = {
    "llama4-maverick-400b-a17b": {"param_dtype": "bfloat16", "fsdp": True},
    "jamba-v0.1-52b": {"param_dtype": "bfloat16", "fsdp": True},
    "deepseek-moe-16b": {"fsdp": True},
    "minicpm3-4b": {"fsdp": True},
}

_aten = torch.ops.aten
_PLAIN_EINSUM = torch.einsum
# Ops given a sharding rule of the dry-run's own, each with the reason:
# DTensor has no strategy for them, or its strategy fails on these
# inputs in torch 2.11 or 2.13. A rule lists, for one mesh dim, the
# placements the op may run under; DTensor redistributes the inputs to
# the cheapest, and the collectives that costs are counted.
RULE_OPS = (
    (_aten.searchsorted.Tensor, "replicate",
     "no DTensor strategy (the MoE dispatch's expert ranks)"),
    (_aten.index.Tensor, "index",
     "torch 2.11 refuses indices sharded on one dim over two mesh dims "
     "(the multi-pod batch over pod and data) in the embedding lookup"),
    (_aten.index_put.default, "index_put",
     "DTensor replicates the indices and values of an index_put, so the "
     "embedding's backward all-gathers the (B, S, d) gradient; an "
     "accumulating one scatters each shard's values into a partial sum"),
    (_aten.index_put_.default, "index_put",
     "no strategy in torch 2.11 (the MoE combine's inverse permutation)"),
    (_aten.gather.default, "gather",
     "torch 2.13's vocab-sharded gather leaves a masked partial whose "
     "mask the loss's following select does not follow (IndexError in "
     "MaskBuffer.apply_mask)"),
    (_aten.constant_pad_nd.default, "pad",
     "torch 2.11's strategy gives a placement list shorter than the "
     "mesh (IndexError in the redistribution of a padded kv block)"),
)
_registered = False


def _index_layout(indices):
    """(first indexed dim, index count, broadcast rank) of an index
    list whose index tensors are contiguous and of one rank, else
    None."""
    pos = [i for i, t in enumerate(indices) if t is not None]
    if not pos or pos[-1] - pos[0] + 1 != len(pos) or \
            len({indices[i].ndim for i in pos}) != 1:
        return None
    return pos[0], len(pos), indices[pos[0]].ndim


def _register_rules():
    """Register `RULE_OPS`' rules with DTensor, once a process."""
    global _registered
    if _registered:
        return
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    R = Replicate()

    def replicate(*args, **kwargs):
        n = sum(1 for a in args if hasattr(a, "placements"))
        return [([R], [R] * n)]

    def index(x, indices):
        n = sum(1 for t in indices if t is not None)
        out = [([R], [R] * (n + 1)), ([Partial()], [Partial(), *[R] * n])]
        layout = _index_layout(indices)
        if layout:
            first, n, rank = layout
            for b in range(rank):          # a dim the indices broadcast
                out.append(([Shard(first + b)], [R, *[Shard(b)] * n]))
            for d in range(x.ndim):        # a dim they do not index
                if not first <= d < first + n:
                    o = d if d < first else d - n + rank
                    out.append(([Shard(o)], [Shard(d), *[R] * n]))
        return out

    def index_put(x, indices, values, accumulate=False):
        n = sum(1 for t in indices if t is not None)
        out = [([R], [R] * (n + 2)),
               ([Partial()], [Partial(), *[R] * n, Partial()])]
        layout = _index_layout(indices)
        if layout:
            first, n, rank = layout
            for d in range(x.ndim):        # a dim they do not index
                if not first <= d < first + n:
                    v = d if d < first else d - n + rank
                    v -= x.ndim - n + rank - values.ndim
                    if v >= 0 and values.shape[v] == x.shape[d]:
                        out.append(([Shard(d)],
                                    [Shard(d), *[R] * n, Shard(v)]))
            if accumulate and values.ndim == x.ndim - n + rank:
                for b in range(rank):      # a dim the indices broadcast
                    out.append(([Partial()], [Partial(), *[Shard(b)] * n,
                                              Shard(first + b)]))
        return out

    def gather(x, dim, idx, *rest, **kwargs):
        dim = dim % x.ndim
        return [([R], [R, R])] + [([Shard(d)], [Shard(d), Shard(d)])
                                  for d in range(x.ndim) if d != dim]

    def pad(x, widths, value=0):
        padded = {x.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
        out = [([R], [R])] + [([Shard(d)], [Shard(d)])
                              for d in range(x.ndim) if d not in padded]
        if not value:
            out.append(([Partial()], [Partial()]))
        return out

    rules = {"replicate": replicate, "index": index,
             "index_put": index_put, "gather": gather, "pad": pad}
    # register_sharding documents that its rule overrides DTensor's own;
    # torch 2.13 looks an op's single-dim strategy up first, so that one
    # is dropped for these ops
    prop = DTensor._op_dispatcher.sharding_propagator
    for op, rule, _ in RULE_OPS:
        register_sharding(op)(rules[rule])
        getattr(prop, "op_single_dim_strategy_funcs", {}).pop(op, None)
    _registered = True


def _meta_dtensor(shape, dtype, spec, mesh):
    """A meta DTensor of global `shape` laid out by `spec`."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"),
                             mesh, placements(spec, mesh))


def _param_struct(model, param_dtype):
    """{key: (shape, dtype)} of the model's params from its meta
    templates, floating leaves in `param_dtype` (the reference's
    `_cast_struct`)."""
    dt = getattr(torch, param_dtype)
    return {k.replace(".", "/"): (tuple(t.shape),
                                  dt if t.is_floating_point() else t.dtype)
            for k, t in model.named_parameters()}


def _distribute(struct, specs, mesh, requires_grad=False):
    return {k: _meta_dtensor(shape, dt, specs[k], mesh).requires_grad_(
        requires_grad) for k, (shape, dt) in struct.items()}


def _local_bytes(tree):
    """Bytes of this rank's shards of every tensor in `tree`."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


def _config(arch) -> ModelConfig:
    return arch if isinstance(arch, ModelConfig) else get_config(arch)


def build_case(arch, shape_name: str, mesh, param_dtype="float32",
               fsdp=False, model_opts=None, policy="baseline"):
    """Returns (step, args, meta): `step(*args)` runs one step of the
    shape's mode on meta DTensors laid out for `mesh`. `arch` is a name
    or a `ModelConfig`."""
    _register_rules()
    cfg = _config(arch)
    shape_cfg = SHAPES[shape_name]
    opts = model_opts or ModelOpts(dtype="bfloat16", remat=True)
    model = build_model(cfg, opts)
    specs = model.input_specs(shape_cfg)
    struct = _param_struct(model, param_dtype)
    pspecs = shard_params({k: torch.empty(s, device="meta")
                           for k, (s, _) in struct.items()}, mesh, fsdp=fsdp,
                          policy=policy)
    meta = {"model": model, "cfg": cfg, "shape": shape_cfg}

    def batch_like(tree, bspecs):
        if isinstance(tree, dict):
            return {k: batch_like(v, bspecs[k]) for k, v in tree.items()}
        return _meta_dtensor(tuple(tree.shape), tree.dtype, bspecs, mesh)

    if shape_cfg.mode == "train":
        params = _distribute(struct, pspecs, mesh, requires_grad=True)
        optimizer = adamw(1e-4)
        f32 = {k: (s, torch.float32) for k, (s, _) in struct.items()}
        opt_state = {"step": torch.zeros((), dtype=torch.int32,
                                         device="meta"),
                     "m": _distribute(f32, pspecs, mesh),
                     "v": _distribute(f32, pspecs, mesh)}
        batch = batch_like(specs["batch"],
                           batch_sharding(mesh, specs["batch"], policy))

        def train_step(params, opt_state, batch):
            loss, _ = model.loss(params, batch)
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                params, opt_state = optimizer.apply(
                    params, opt_state, dict(zip(params, grads)))
            return params, opt_state, loss

        return train_step, (params, opt_state, batch), meta

    params = _distribute(struct, pspecs, mesh)
    if shape_cfg.mode == "prefill":
        inputs = batch_like(specs, batch_sharding(mesh, specs, policy))

        def prefill_step(params, tokens, frontend=None):
            with torch.no_grad():
                return model.prefill(params, tokens, frontend=frontend)

        return (prefill_step, (params, inputs["tokens"],
                               inputs.get("frontend")), meta)

    # decode
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    token = batch_like(specs["token"], batch_sharding(mesh, specs["token"]))
    cspecs = cache_sharding(mesh, specs["cache"], B)
    cache = {k: _meta_dtensor(tuple(v.shape), v.dtype, cspecs[k], mesh)
             for k, v in specs["cache"].items()}
    pos = S + model.n_prefix     # the cache's one free slot

    def serve_step(params, token, cache, pos):
        with torch.no_grad():
            return model.decode_step(params, token, cache, pos)

    return serve_step, (params, token, cache, pos), meta


def _capture_inputs(model):
    """A hook on the first stack super-block that records the placements
    of the input (and encoder output) the step hands it: {"x",
    "enc_out"}, filled on the first call. Returns (the dict, the hook's
    handle)."""
    seen = {}

    def hook(module, args, kwargs):
        if not seen:
            enc = kwargs.get("enc_out")
            seen["x"] = tuple(args[0].placements)
            seen["enc_out"] = (tuple(enc.placements) if enc is not None
                               else None)

    if not model.repeats:
        return seen, None
    return seen, model.stack[0]["t0"].register_forward_pre_hook(
        hook, with_kwargs=True)


def _letters(eq, operands):
    """An einsum equation's subscripts, one string an operand and the
    output, "..." spelled out in letters the equation does not use."""
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    spare = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq]
    width = max((op.ndim - len(s) + 3 for s, op in zip(ins, operands)
                 if "..." in s), default=0)
    ell = "".join(spare[:width])
    ins = [s.replace("...", ell[len(ell) - (op.ndim - len(s) + 3):])
           if "..." in s else s for s, op in zip(ins, operands)]
    return ins, out.replace("...", ell)


def _shard_like(p, dim):
    """Placement `p` (a Shard or _StridedShard) moved to tensor dim
    `dim`."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    if isinstance(p, _StridedShard):
        return _StridedShard(dim, split_factor=p.split_factor)
    return Shard(dim)


def partitioned_einsum(eq, *operands):
    """einsum over DTensors, partitioned a mesh dim at a time as a
    dot-general partitioner does: operands sharded on one subscript
    compute it locally (a subscript in the output stays sharded, a
    contracted one leaves a partial sum); an operand that lacks that
    sharding is split locally (no collective); where operands are
    sharded on different subscripts, the one kept is the one that moves
    the fewest elements (the other operands gathered on that mesh dim,
    and the output, if it is contracted, reduced later); a partial
    operand beside non-replicated others is reduced first. The local
    einsum runs on the shards.
    (DTensor's own einsum flattens operand dims into a matmul and
    refuses to flatten a sharded inner dim.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = next(o.device_mesh for o in operands if isinstance(o, DTensor))
    ops = [o if isinstance(o, DTensor) else
           DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                              run_check=False) for o in operands]
    ins, out = _letters(eq, ops)
    size = {c: n for s, o in zip(ins, ops) for c, n in zip(s, o.shape)}
    want = [list(o.placements) for o in ops]
    out_pl = []
    for m in range(mesh.ndim):
        cur = [w[m] for w in want]
        partial = [i for i, p in enumerate(cur) if p.is_partial()]
        if partial and (len(partial) > 1 or any(
                not p.is_replicate() for i, p in enumerate(cur)
                if i not in partial)):
            for i in partial:
                want[i][m] = cur[i] = Replicate()
            partial = []
        if partial:
            out_pl.append(Partial())
            continue
        sharded = {i: (ins[i][p.dim], p) for i, p in enumerate(cur)
                   if p.is_shard()}
        if not sharded:
            out_pl.append(Replicate())
            continue
        out_numel = math.prod(size[c] for c in out)

        def cost(i):
            """Elements moved if operand i's subscript is kept: every
            operand sharded on another is gathered, and a contracted
            subscript leaves the output to be reduced."""
            letter = sharded[i][0]
            return (sum(ops[j].numel() for j, (c, _) in sharded.items()
                        if c != letter)
                    + (0 if letter in out else out_numel))

        keep = min(sharded, key=lambda i: (cost(i), -ops[i].numel()))
        letter, place = sharded[keep]
        for i in range(len(ops)):
            if letter in ins[i]:
                p = _shard_like(place, ins[i].index(letter))
            else:
                p = Replicate()
            want[i][m] = p
        out_pl.append(_shard_like(place, out.index(letter))
                      if letter in out else Partial())
    ops = [o.redistribute(mesh, w) if list(o.placements) != w else o
           for o, w in zip(ops, want)]
    # the gradient of an operand replicated on a mesh dim where another
    # is not is a partial sum there; a partial operand's is replicated
    grads = [[Partial() if p.is_replicate() and any(
                  not w[m].is_replicate() for w in want) else
              Replicate() if p.is_partial() else p
              for m, p in enumerate(w)] for w in want]
    local = _PLAIN_EINSUM(f"{','.join(ins)}->{out}",
                          *[o.to_local(grad_placements=g)
                            for o, g in zip(ops, grads)])
    shape = torch.Size(size[c] for c in out)
    return DTensor.from_local(local, mesh, out_pl, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


@contextlib.contextmanager
def _einsum_partitioner():
    """`torch.einsum` over DTensors goes to `partitioned_einsum` while
    active. It replaces the function itself, not a thread's mode: the
    backward (and a checkpointed super-block's recompute in it) runs in
    autograd's own thread."""
    from torch.distributed.tensor import DTensor
    plain = torch.einsum

    def einsum(eq, *operands):
        if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
            operands = tuple(operands[0])
        if any(isinstance(o, DTensor) for o in operands):
            return partitioned_einsum(eq, *operands)
        return plain(eq, *operands)

    torch.einsum = einsum
    try:
        yield
    finally:
        torch.einsum = plain


def _run(step, args, mesh):
    """Run `step(*args)` under DTensor's implicit replication (plain
    tensors made inside the model count as replicated), the einsum
    partitioner and the recorder. Returns (outputs, recorder)."""
    from torch.distributed.tensor.experimental import implicit_replication
    rec = CollectiveRecorder.for_mesh(mesh)
    with implicit_replication(), _einsum_partitioner(), rec:
        out = step(*args)
    return out, rec


def stack_probe_collectives(model, shape_cfg, mesh, params,
                            policy="baseline", inputs=None):
    """Per-device collective bytes of ONE stack super-block (the first),
    run alone under the model's placements (in train, its gradient wrt
    its input only). Its input is batch-sharded, as the reference's, or
    laid out as `inputs` gives ({"x", "enc_out"}: placements, what
    `_capture_inputs` saw the full step hand the super-block). The
    reference needs it to correct its HLO count, which sees a scanned
    body once; the port's count is direct, and this keeps the
    reference's probe keys. Returns (collective_bytes, repeats). The
    reference's `fsdp` and `param_dtype` arguments are already in
    `params`' placements and dtypes."""
    if model.repeats < 1:
        return {"total": 0}, 0
    cfg = model.cfg
    sizes = axis_sizes(mesh)
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    if cfg.frontend == "vision_stub" and shape_cfg.mode != "decode":
        S = S + cfg.frontend_tokens
    baxes = (("pod", "data", "model") if policy == "pure_dp"
             else ("pod", "data"))
    bx = tuple(a for a in baxes if a in sizes)
    bsz = 1
    for a in bx:
        bsz *= sizes[a]
    bleaf = bx if (B % bsz == 0 and B >= bsz) else None
    dt = model.opts.tdtype
    mode = shape_cfg.mode
    sb = model.stack[0]
    blocks = [(f"stack/0/t{t}", sb[f"t{t}"]) for t in range(model.period)]

    def block_params(name):
        return {k[len(name) + 1:]: v for k, v in params.items()
                if k.startswith(name + "/")}

    def meta_input(shape, name):
        from torch.distributed.tensor import distribute_tensor
        if inputs and inputs.get(name) is not None:
            return distribute_tensor(torch.empty(shape, dtype=dt,
                                                 device="meta"),
                                     mesh, inputs[name])
        return _meta_dtensor(shape, dt, P(bleaf, None, None), mesh)

    x = meta_input((B, 1 if mode == "decode" else S, cfg.d_model), "x")
    enc_out = (meta_input((B, cfg.enc_tokens, cfg.d_model), "enc_out")
               if model.has_cross and mode != "decode" else None)
    if mode == "decode":
        cache = {k: v for k, v in model.make_cache(B, S + 1, "meta").items()
                 if k.startswith("stack/0/")}
        cspecs = cache_sharding(mesh, cache, B)
        cache = {k: _meta_dtensor(tuple(v.shape), v.dtype, cspecs[k], mesh)
                 for k, v in cache.items()}

    def probe(x):
        y = x
        for name, blk in blocks:
            if mode == "decode":
                keys = model.cache_keys[blk.kind]
                y, _, _ = apply_params(blk, block_params(name), y,
                                       cache={k: cache[f"{name}/{k}"]
                                              for k in keys}, pos=S)
            else:
                y, _, _ = apply_params(
                    blk, block_params(name), y, 0,
                    0 if mode == "train" else S + 1, enc_out=enc_out)
        return y

    def step(x):
        if mode == "train":
            x = x.detach().requires_grad_()
            y = probe(x).float().mean()
            return torch.autograd.grad(y, x)
        with torch.no_grad():
            return probe(x)

    _, rec = _run(step, (x,), mesh)
    return collective_bytes(rec.records), model.repeats


def model_flops(cfg, shape_cfg):
    """6·N·D (dense) / 6·N_active·D (MoE) — the useful-FLOPs yardstick."""
    n_active = cfg.param_count(active_only=True)
    if shape_cfg.mode == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 6 * n_active * tokens
    if shape_cfg.mode == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 2 * n_active * tokens
    return 2 * n_active * shape_cfg.global_batch  # decode: 1 token


def applicable(cfg, shape_name):
    if shape_name == "long_500k" and not cfg.subquadratic():
        return False, "pure full-attention arch: 500k decode skipped " \
                      "(DESIGN.md §6)"
    return True, ""


def dryrun_one(arch, shape_name, *, multi_pod=False, mesh_shape=None,
               param_dtype=None, fsdp=None, model_opts=None, save=True,
               tag="", policy="baseline"):
    """One case's record. `arch` is a name or a `ModelConfig`; a case
    that raises is recorded with status "error" and its traceback."""
    cfg = _config(arch)
    name = cfg.name
    ok, why = applicable(cfg, shape_name)
    rec = {"arch": name, "shape": shape_name,
           "mesh": "multi_pod" if multi_pod else "single_pod", "tag": tag}
    if not ok:
        rec.update(status="skipped", reason=why)
        _save(rec, save)
        return rec
    ov = ARCH_OVERRIDES.get(name, {})
    param_dtype = param_dtype or ov.get("param_dtype", "float32")
    fsdp = ov.get("fsdp", False) if fsdp is None else fsdp
    rec.update(param_dtype=param_dtype, fsdp=fsdp, policy=policy)
    mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape)
    t0 = time.time()
    try:
        step, args, meta = build_case(cfg, shape_name, mesh, param_dtype,
                                      fsdp, model_opts, policy=policy)
        seen, handle = _capture_inputs(meta["model"])
        out, rec_top = _run(step, args, mesh)
        t_trace = time.time() - t0
        if handle is not None:
            handle.remove()
        coll_top = collective_bytes(rec_top.records)
        by_axis = bytes_by_axis(rec_top.records)
        try:
            coll_probe, repeats = stack_probe_collectives(
                meta["model"], meta["shape"], mesh, args[0],
                policy=policy, inputs=seen)
        except Exception as e:   # the probe is a cross-check only
            coll_probe, repeats = {"total": 0}, 0
            rec["probe_error"] = f"{type(e).__name__}: {e}"
        chips = n_chips(mesh)
        sizes = axis_sizes(mesh)
        mf = model_flops(meta["cfg"], meta["shape"])
        a_flops = analytic.step_flops(
            meta["cfg"], meta["shape"],
            remat=meta["model"].opts.remat) / chips
        eff_model_axis = (1 if policy == "pure_dp"
                          else sizes.get("model", 1))
        a_bytes = analytic.step_hbm_bytes(
            meta["cfg"], meta["shape"], chips,
            param_bytes=getattr(torch, param_dtype).itemsize,
            fsdp=fsdp, model_axis=eff_model_axis,
            data_axis=sizes.get("data", 1))
        coll_s = sum(b / axis_bandwidth(mesh, a) for a, b in by_axis.items())
        rec.update(
            status="ok", chips=chips, trace_s=round(t_trace, 1),
            # analytic roofline numerators, per chip:
            flops_per_chip=a_flops, hbm_bytes_per_chip=a_bytes,
            # this rank's matmul/attention FLOPs, a cross-check
            counted_flops=float(rec_top.flops),
            collective_bytes=coll_top,
            collective_probe_bytes=coll_probe, stack_repeats=repeats,
            collective_bytes_corrected=coll_top["total"],
            collective_bytes_by_axis={str(a): b for a, b in by_axis.items()},
            model_flops=mf,
            useful_flops_ratio=(mf / (a_flops * chips)
                                if a_flops else None),
            compute_term_s=a_flops / PEAK_FLOPS_BF16,
            memory_term_s=a_bytes / HBM_BW,
            collective_term_s=coll_s,
            params=meta["cfg"].param_count(),
            params_active=meta["cfg"].param_count(active_only=True),
            mem_argument_size_in_bytes=_local_bytes(args),
            mem_output_size_in_bytes=_local_bytes(out),
        )
        terms = {"compute": rec["compute_term_s"],
                 "memory": rec["memory_term_s"],
                 "collective": rec["collective_term_s"]}
        rec["bottleneck"] = max(terms, key=terms.get)
    except Exception as e:  # record the failure — these are bugs to fix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    _save(rec, save)
    return rec


def _save(rec, save):
    if not save:
        return
    os.makedirs(RESULTS_DIR, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}"
    if rec.get("tag"):
        name += f"_{rec['tag']}"
    with open(os.path.join(RESULTS_DIR, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--param-dtype", default=None)
    ap.add_argument("--fsdp", action="store_true", default=None)
    ap.add_argument("--mesh-shape", default=None,
                    help="comma ints, e.g. 4,4 (debug)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--policy", default="baseline")
    args = ap.parse_args()
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split(","))
                  if args.mesh_shape else None)

    if args.all:
        from repro_torch.configs import list_archs
        archs = [a for a in list_archs() if a != "paper-drl-trunk"]
        cases = [(a, s) for a in archs for s in SHAPES]
    else:
        cases = [(args.arch, args.shape)]
    for arch, shape in cases:
        rec = dryrun_one(arch, shape, multi_pod=args.multi_pod,
                         mesh_shape=mesh_shape,
                         param_dtype=args.param_dtype, fsdp=args.fsdp,
                         tag=args.tag, policy=args.policy)
        keys = ("status", "trace_s", "counted_flops", "compute_term_s",
                "memory_term_s", "collective_term_s", "bottleneck",
                "reason", "error")
        print(json.dumps({"arch": arch, "shape": shape,
                          **{k: rec[k] for k in keys if k in rec}}),
              flush=True)


if __name__ == "__main__":
    main()
