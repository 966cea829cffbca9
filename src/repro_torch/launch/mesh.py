"""Production mesh builders and the roofline's hardware constants (the
port of src/repro/launch/mesh.py).

The reference lays its meshes over XLA's fake host devices; the port
lays them over a fake process group (`torch.distributed`'s "fake"
backend, whose collectives move nothing): a `DeviceMesh` of world size
256 or 512 in one process, on which DTensor partitions a step on meta
tensors, as XLA's SPMD partitioner does over the reference's 512 host
devices. Functions, not module-level constants, so importing this module
initialises no process group.

The roofline's constants are those of one NVIDIA H100 SXM5 (700 W), from
NVIDIA's data sheet: published peaks, not measurements. The reference's
TPU v5e has one uniform ICI link rate; an H100 cluster has two tiers, so
the collective term takes NVLink's rate for a mesh axis whose every group
lies within one 8-GPU node (in the production meshes, the innermost axis
at size 8 or less) and InfiniBand's otherwise (`axis_bandwidth`).
"""
from __future__ import annotations

import math

PEAK_FLOPS_BF16 = 989.4e12   # FLOP/s, bf16 dense tensor core (data sheet)
HBM_BW = 3.35e12             # bytes/s, HBM3 (data sheet)
NVLINK_BW = 450e9            # bytes/s a direction per GPU, NVLink 4 (data sheet)
IB_BW = 50e9                 # bytes/s per GPU, one InfiniBand NDR 400 Gb/s port
GPUS_PER_NODE = 8            # HGX H100 node


def _axes(shape):
    return (("pod", "data", "model") if len(shape) == 3
            else ("data", "model"))


def _fake_group(world_size: int):
    """Initialise the fake process group of `world_size` ranks (this
    process is rank 0), or check the one that exists."""
    import torch.distributed as dist
    if dist.is_initialized():
        have = dist.get_world_size()
        if have != world_size:
            raise RuntimeError(
                f"a process group of world size {have} exists; this mesh "
                f"needs {world_size} (run each mesh size in its own "
                f"process, as launch/dryrun.py does)")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, shape=None):
    """16x16 = 256 GPUs a pod; `multi_pod` adds a 2-pod leading axis.
    `shape` overrides for scaled-down runs (same axis names). A
    `DeviceMesh` over the fake process group of that world size, which
    it initialises if none exists; RuntimeError if one of another size
    does."""
    from torch.distributed.device_mesh import init_device_mesh
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    shape = tuple(shape)
    _fake_group(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=_axes(shape))


def make_worker_mesh(n_workers: int):
    """1-D worker mesh for the DRL topology/sync experiments."""
    from torch.distributed.device_mesh import init_device_mesh
    _fake_group(n_workers)
    return init_device_mesh("cpu", (n_workers,),
                            mesh_dim_names=("workers",))


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh`, or of any mesh-like object
    whose `shape` is already such a mapping (the reference's meshes and
    the tests' stubs)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh):
    """Mesh axes the global batch shards over."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def n_chips(mesh):
    return math.prod(axis_sizes(mesh).values())


def axis_bandwidth(mesh, axis) -> float:
    """Bytes/s of a collective over mesh `axis`: NVLink's when every
    group along it lies within one node of GPUS_PER_NODE ranks,
    InfiniBand's otherwise (and for an axis this mesh does not name)."""
    names = list(mesh.mesh_dim_names)
    if axis not in names:
        return IB_BW
    ranks = mesh.mesh.movedim(names.index(axis), -1)
    ranks = ranks.reshape(-1, ranks.shape[-1]) // GPUS_PER_NODE
    within = bool((ranks == ranks[:, :1]).all())
    return NVLINK_BW if within else IB_BW
