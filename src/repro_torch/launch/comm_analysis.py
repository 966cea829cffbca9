"""Per-device collective traffic of a partitioned step: the port of
src/repro/launch/hlo_analysis.py.

The reference parses XLA's post-SPMD HLO text and sums each collective's
result shape. The port has no HLO: DTensor issues its collectives as
`_c10d_functional` ops on the local shards, and `CollectiveRecorder` (a
TorchDispatchMode) records each one as it runs — its kind, its
per-device result bytes (the reference's convention: the result's shape,
not the bytes on the wire) and the mesh axis it ran over. Every op is
seen, so a loop over layers is counted in full: there is no scan body to
correct for.
"""
from __future__ import annotations

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")

# op name (`_c10d_functional.<name>` or `_dtensor.<name>`) -> kind
_KINDS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all"}


def _nbytes(out):
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return out.numel() * out.element_size()


class CollectiveRecorder(TorchDispatchMode):
    """Records (kind, per-device result bytes, mesh axis) of every
    collective issued while active, and sums the FLOPs of the local ops
    (`flops`, torch.utils.flop_counter's formulas: matmuls, convolutions,
    attention). `axes` maps a process group's name to its mesh axis
    (`for_mesh`); a group it does not name is recorded under None.

    An op on DTensors is handed back (NotImplemented) so that DTensor
    runs first and this mode sees the local ops and collectives it
    issues, as torch's CommDebugMode does."""

    def __init__(self, axes=None):
        super().__init__()
        self.axes = dict(axes or {})
        self.records = []
        self.flops = 0

    @classmethod
    def for_mesh(cls, mesh):
        return cls({mesh.get_group(i).group_name: name
                    for i, name in enumerate(mesh.mesh_dim_names)})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        ns = func.namespace
        name = func._opname
        if ns in ("_c10d_functional", "_dtensor") and name in _KINDS:
            group = kwargs.get("group_name", args[-1])
            self.records.append((_KINDS[name], _nbytes(out),
                                 self.axes.get(group)))
        return out


def collective_bytes(records):
    """Per-device bytes moved by collectives, summed per op kind, from
    `CollectiveRecorder.records`, with "total" and "counts" as the
    reference returns them."""
    out = {k: 0 for k in _COLL_OPS}
    counts = {k: 0 for k in _COLL_OPS}
    for kind, nbytes, _ in records:
        out[kind] += nbytes
        counts[kind] += 1
    out["total"] = sum(out[k] for k in _COLL_OPS)
    out["counts"] = counts
    return out


def bytes_by_axis(records) -> dict:
    """{mesh axis: per-device result bytes} (None: a group no axis
    names)."""
    out = {}
    for _, nbytes, axis in records:
        out[axis] = out.get(axis, 0) + nbytes
    return out


# ring-algorithm bytes-on-wire factors per result byte (16-way groups):
# all-reduce = 2(n-1)/n; all-gather/all-to-all = (n-1)/n;
# reduce-scatter ~ (n-1) (result is 1/n of the reduced input); permute = 1
WIRE_FACTORS = {"all-reduce": 1.875, "all-gather": 0.9375,
                "reduce-scatter": 15.0, "all-to-all": 0.9375,
                "collective-permute": 1.0}


def wire_bytes(kinds: dict) -> float:
    """Bytes-on-wire estimate from a per-kind result-bytes dict."""
    return sum(kinds.get(k, 0) * f for k, f in WIRE_FACTORS.items())
