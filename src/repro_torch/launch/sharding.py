"""Sharding rules: param/cache/batch partition specs for the production
mesh (megatron-style tensor parallel on `model`, data parallel on
`pod`+`data`, optional ZeRO-3/FSDP over `data`) — the port of
src/repro/launch/sharding.py.

Rules are name-based with divisibility-checked fallbacks: if the
preferred dim of a leaf doesn't divide by the axis size (e.g. smollm's
15 heads on a 16-way model axis) the rule falls through to the next
candidate dim and ultimately to replication — every decision is
auditable via `explain_sharding`.

A spec is a `PartitionSpec`: a tuple with one entry a dim, each an axis
name, a tuple of axis names or None (replicated), as JAX's; `placements`
turns it into DTensor placements on a `DeviceMesh`. `param_pspec` is a
pure function of (path, shape, mesh sizes, fsdp, policy) and gives the
reference's spec on the same inputs.

The port holds one leaf a layer (`stack/<r>/t<t>/...`,
checkpoint/convert.py), where the reference stacks each super-block
position's leaves along a leading layer dim. The rules index dims from
the right, so on the reference's stacked leaves they sometimes read the
layer dim; applied to the port's per-layer leaves they read the dims the
rule table names. So `shard_params` on the port's leaves differs from
the reference's plan, its leading layer entry dropped, in two classes of
leaf, and in no other (tests/test_torch_sharding.py counts them):
  * the reference puts an axis on the layer dim: a stacked dense FFN
    leaf (R, d, f) passes the MoE test (`len(shape) >= 3 and shape[-3]
    >= 4`) and puts `model` on R; RWKV's stacked `mixer/wo` (R, d, d)
    matches the attention rule `(mixer|xattn)/wo` and reads dim -3,
    which is R; under fsdp a stacked leaf whose largest free dim is R
    (Mamba's `D`, `conv_b`, `dt_bias`, `dt_proj`) puts `data` on it.
    The port shards dense `ffn/wi` by columns, RWKV's `wo` by rows, and
    those Mamba vectors as the rule table says;
  * a per-layer leaf under 1024 elements whose stack is not (a norm's
    scale): the port replicates it (the size test), where the reference
    shards the stack under fsdp.
"""
from __future__ import annotations

import math
import re

from repro_torch.launch.mesh import axis_sizes


class PartitionSpec(tuple):
    """One entry a dim: an axis name, a tuple of axis names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# (path regex, candidate dims to shard over `model`, in priority order)
# dims are indices *from the right* of the leaf (robust to stacked
# leading layer dims from scan-over-layers).
_MODEL_RULES = (
    (r"embed/tok$", (2,)),             # (V, d): vocab
    (r"embed/unembed$", (1,)),         # (d, V): vocab
    (r"projector$", (1,)),             # (fd, d)
    (r"(mixer|xattn)/wq$", (2, 1)),    # (d, H, hd): heads, then hd
    (r"(mixer|xattn)/wk$", (2, 1)),
    (r"(mixer|xattn)/wv$", (2, 1)),
    (r"(mixer|xattn)/wo$", (3, 2)),    # (H, hd, d): heads
    (r"mixer/wuq$", (2, 1)),           # MLA (rq, H, hd)
    (r"mixer/wqr$", (2,)),
    (r"mixer/wuk$", (2,)),             # (rkv, H, hd)
    (r"mixer/wuv$", (2,)),
    (r"mixer/wdq$", (1,)),             # (d, rq)
    (r"ffn/(wi|wg)$", (1,)),           # dense mlp (d, f) OR moe (E, d, f)
    (r"ffn/wo$", (2,)),                # dense (f, d) OR moe (E, f, d)
    (r"shared/(wi|wg)$", (1,)),        # (d, f*ns)
    (r"shared/wo$", (2,)),             # (f*ns, d)
    (r"mixer/(wr|wk|wv|wg)$", (1,)),   # rwkv (d, d): columns
    (r"mixer/wo$", (2,)),              # rwkv (d, d): rows
    (r"mixer/in_proj$", (1,)),         # mamba (d, 2di)
    (r"mixer/out_proj$", (2,)),        # (di, d)
    (r"mixer/(conv_w|conv_b|dt_bias|D)$", (1,)),  # (..., di)
    (r"mixer/bc_proj$", (2,)),         # (di, 2N)
    (r"mixer/dt_proj$", (2,)),         # (di, 1)
    (r"mixer/A_log$", (2,)),           # (di, N)
)

_MOE_EXPERT_RULE = re.compile(r"ffn/(wi|wg|wo)$")
_ATTN_RULE = re.compile(r"(mixer|xattn)/(wq|wk|wv|wo|wuq|wqr|wuk|wuv|"
                        r"wdq)$")
_EMBED_RULE = re.compile(r"embed/(tok|unembed)$")

# Sharding policies ("baseline" is the naive always-shard-something
# scheme):
#   baseline        — rule table with full fallback chain
#   attn_heads_only — attention leaves shard ONLY when the head dim
#                     divides; otherwise replicate (avoids score-matrix
#                     all-reduces when heads < model axis)
#   +embed_d        — embedding/unembedding shard d_model instead of
#                     vocab (decode: one logits psum instead of a full
#                     table all-gather)
#   pure_dp         — no tensor parallelism at all: params replicated,
#                     batch sharded over EVERY mesh axis (collective cost
#                     collapses to one grad all-reduce)
POLICIES = ("baseline", "attn_heads_only", "attn_heads_only+embed_d",
            "pure_dp")
MIN_SHARDED = 1024   # leaves with fewer elements stay replicated


def param_pspec(path_str: str, shape, mesh, fsdp: bool = False,
                policy: str = "baseline"):
    """PartitionSpec for one param leaf."""
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)
    data = sizes.get("data", 1)
    spec = [None] * len(shape)
    if policy == "pure_dp":
        if fsdp and data > 1:  # ZeRO storage sharding only
            cands = sorted((s, i) for i, s in enumerate(shape)
                           if s % data == 0 and s >= data)
            if cands:
                spec[cands[-1][1]] = "data"
        return P(*spec)
    # expert-parallel: MoE expert dim (rank-3 ffn leaves) over `model`
    is_moe = (_MOE_EXPERT_RULE.search(path_str) and len(shape) >= 3
              and shape[-3] >= 4)
    if is_moe and shape[-3] % model == 0:
        spec[len(shape) - 3] = "model"
    else:
        for rx, dims in _MODEL_RULES:
            if re.search(rx, path_str):
                if policy != "baseline" and _ATTN_RULE.search(path_str):
                    dims = dims[:1]   # heads or nothing — no fallback
                if "embed_d" in policy and _EMBED_RULE.search(path_str):
                    # shard d_model instead of vocab
                    dims = ((1,) if path_str.endswith("tok") else (2,))
                for dfr in dims:  # dim index from the right
                    i = len(shape) - dfr
                    if 0 <= i < len(shape) and shape[i] % model == 0 \
                            and shape[i] >= model:
                        spec[i] = "model"
                        break
                break
    if fsdp and data > 1:
        # ZeRO-3: shard the largest remaining free dim over `data`
        cands = sorted((s, i) for i, s in enumerate(shape)
                       if spec[i] is None and s % data == 0 and s >= data)
        if cands:
            spec[cands[-1][1]] = "data"
    return P(*spec)


def _leaf_spec(path, shape, mesh, fsdp, policy):
    if len(shape) == 0 or math.prod(shape) < MIN_SHARDED:
        return P()
    return param_pspec(path, shape, mesh, fsdp, policy)


def shard_params(params, mesh, fsdp: bool = False,
                 policy: str = "baseline") -> dict:
    """{key: PartitionSpec} for a flat params (or optimizer-moment) dict
    of tensors (anything with a `shape`), keyed by the port's key
    paths."""
    return {k: _leaf_spec(k, tuple(v.shape), mesh, fsdp, policy)
            for k, v in params.items()}


def explain_sharding(params, mesh, fsdp: bool = False, limit=None,
                     policy: str = "baseline"):
    """(key, shape, spec) for every leaf (the first `limit`)."""
    return [(k, tuple(v.shape), _leaf_spec(k, tuple(v.shape), mesh, fsdp,
                                           policy))
            for k, v in list(params.items())[:limit]]


def placements(spec, mesh):
    """DTensor placements on `mesh` (a `DeviceMesh`) for a spec: Shard(i)
    on every mesh axis named in entry i, Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for i, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[names.index(axis)] = Shard(i)
    return out


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------

def _bdims(mesh, policy="baseline"):
    names = (("pod", "data", "model") if policy == "pure_dp"
             else ("pod", "data"))
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in names if a in sizes)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_sharding(mesh, batch_struct, policy="baseline"):
    """Shard every batch leaf on dim 0 (global batch): a spec for a leaf
    (anything with a `shape`), the same nesting of specs for a dict."""
    bx = _bdims(mesh, policy)
    sizes = axis_sizes(mesh)
    n = sizes.get("pod", 1) * sizes.get("data", 1)
    if policy == "pure_dp":
        n *= sizes.get("model", 1)

    def one(leaf):
        if isinstance(leaf, dict):
            return {k: one(v) for k, v in leaf.items()}
        shape = tuple(leaf.shape)
        if shape and shape[0] % n == 0 and shape[0] >= n:
            return P(bx)
        return P()
    return one(batch_struct)


def cache_sharding(mesh, cache, batch: int) -> dict:
    """{key: PartitionSpec} for the port's flat KV/recurrent-state cache
    (one entry a layer, no leading layer dim).

    batch >= data axis: shard batch dim. batch == 1 (long_500k): shard
    the *sequence/capacity* dim of kv-type leaves over `data` (distributed
    flash-decode — DTensor inserts the partial-softmax collectives), and
    the head/channel dim of recurrent state over `model`.
    """
    sizes = axis_sizes(mesh)
    n = sizes.get("pod", 1) * sizes.get("data", 1)
    data = sizes.get("data", 1)
    model = sizes.get("model", 1)
    bx = _bdims(mesh)

    def one(key, shape):
        name = key.rsplit("/", 1)[-1]
        spec = [None] * len(shape)
        bdim = 0
        if shape[bdim] % n == 0 and shape[bdim] >= n:
            spec[bdim] = bx
        else:
            # batch too small: shard capacity (kv) over data
            if name in ("k", "v", "ckv", "kr", "ek", "ev") \
                    and len(shape) > bdim + 1 \
                    and shape[bdim + 1] % data == 0 \
                    and shape[bdim + 1] >= data:
                spec[bdim + 1] = "data"
            elif name in ("S",) and shape[bdim + 1] % model == 0:
                spec[bdim + 1] = "model"   # rwkv state heads
            elif name in ("conv", "ssm") and shape[-2 if name == "ssm"
                                                   else -1] % model == 0:
                spec[len(shape) - (2 if name == "ssm" else 1)] = "model"
        # also shard kv heads/channels over model when possible
        if name in ("k", "v", "ek", "ev") and len(shape) >= bdim + 3:
            kvh_dim = bdim + 2
            if spec[kvh_dim] is None and shape[kvh_dim] % model == 0 \
                    and shape[kvh_dim] >= model:
                spec[kvh_dim] = "model"
        return P(*spec)

    return {k: one(k, tuple(v.shape)) for k, v in cache.items()}
