"""The port's dry-run planning (repro_torch.launch.{sharding,analytic,
comm_analysis} and `LanguageModel.input_specs`) against the JAX package's
on identical inputs, on the CPU: every leaf of every arch, full width,
shapes only (jax.eval_shape and meta tensors; nothing is allocated)."""
import math
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.launch import analytic as janalytic
from repro.launch import sharding as jsharding
from repro.launch.hlo_analysis import wire_bytes as jwire_bytes
from repro.models import build_model as jbuild_model
from repro.models.model import ModelOpts as JModelOpts
from repro_torch.checkpoint.convert import _stack_split, flatten_tree
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import analytic, dryrun, sharding
from repro_torch.launch.comm_analysis import collective_bytes, wire_bytes
from repro_torch.launch.mesh import axis_sizes, batch_axes, n_chips
from repro_torch.models.model import ModelOpts, build_model

# repro.launch.dryrun sets XLA_FLAGS for 512 host devices when imported;
# put the variable back, so this process (and what it starts) keeps the
# one device tests/test_sharding_dryrun.py requires
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

ARCHS = list_archs()
MESHES = {"16x16": (16, 16), "4x4": (4, 4), "2x16x16": (2, 16, 16)}


def _mesh(shape):
    """An abstract JAX mesh: both packages read its `shape` mapping."""
    return AbstractMesh(tuple(shape), ("pod", "data", "model")[-len(shape):])


_STRUCTS = {}


def _structs(arch):
    """(the reference's flat stacked param shapes, the port's flat
    per-layer param shapes) of `arch` at full width."""
    if arch not in _STRUCTS:
        ref = jax.eval_shape(jbuild_model(arch, JModelOpts()).init,
                             jax.random.PRNGKey(0))
        port = build_model(arch, ModelOpts())
        _STRUCTS[arch] = (
            {k: tuple(v.shape) for k, v in flatten_tree(ref).items()},
            {k.replace(".", "/"): tuple(t.shape)
             for k, t in port.named_parameters()})
    return _STRUCTS[arch]


def _full(spec, ndim):
    """A spec as a tuple with one entry a dim."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _ref_leaf_spec(key, shape, mesh, fsdp, policy):
    """The reference's `shard_params` decision for one stacked leaf."""
    if len(shape) == 0 or math.prod(shape) < 1024:
        return (None,) * len(shape)
    return _full(jsharding.param_pspec(key, shape, mesh, fsdp, policy),
                 len(shape))


class _Shaped:
    def __init__(self, shape):
        self.shape = shape


# ---------------------------------------------------------------- rules
@pytest.mark.parametrize("policy", sharding.POLICIES)
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_pspec_matches_reference_on_every_leaf(mesh, fsdp, policy):
    """`param_pspec` on the reference's own stacked paths and shapes
    gives the reference's spec, for every leaf of every arch."""
    m = _mesh(MESHES[mesh])
    n = 0
    for arch in ARCHS:
        ref, _ = _structs(arch)
        for key, shape in ref.items():
            want = _full(jsharding.param_pspec(key, shape, m, fsdp, policy),
                         len(shape))
            got = _full(sharding.param_pspec(key, shape, m, fsdp, policy),
                        len(shape))
            assert got == want, (arch, key, shape, got, want)
            n += 1
    assert n > 300


# The port's leaves are one a layer; the reference's stack each
# super-block position along a leading layer dim. Where the plans differ,
# the leaf is in one of two classes (launch/sharding.py's docstring):
# (a) the reference puts a mesh axis on the layer dim; (b) one layer's
# leaf is under 1024 elements, so the port replicates it, where its stack
# is not. Counts of stacked reference leaves in each class, per (mesh,
# fsdp, policy); (b) depends on sizes alone (16 leaves: the norms of
# smollm, whisper's encoder and decoder, the policy trunk, and MiniCPM3's
# latent norms).
LAYER_DIM = {  # class (a): (fsdp False, fsdp True) per policy
    "16x16": {"baseline": (3, 3), "attn_heads_only": (3, 3),
              "attn_heads_only+embed_d": (3, 3), "pure_dp": (0, 0)},
    "4x4": {"baseline": (43, 71), "attn_heads_only": (43, 71),
            "attn_heads_only+embed_d": (43, 71), "pure_dp": (0, 0)},
    "2x16x16": {"baseline": (3, 3), "attn_heads_only": (3, 3),
                "attn_heads_only+embed_d": (3, 3), "pure_dp": (0, 0)},
}
SMALL_LAYER = 16  # class (b)


@pytest.mark.parametrize("policy", sharding.POLICIES)
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_whole_model_plan_differs_only_in_the_two_classes(mesh, fsdp,
                                                          policy):
    """`shard_params` over the port's per-layer leaves equals the
    reference's plan with its leading layer entry dropped on every leaf
    but the two enumerated classes, and equals it exactly off the
    stacks."""
    m = _mesh(MESHES[mesh])
    layer_dim = small = 0
    for arch in ARCHS:
        ref, port = _structs(arch)
        specs = sharding.shard_params(
            {k: _Shaped(s) for k, s in port.items()}, m, fsdp, policy)
        keys = set()
        for key, shape in ref.items():
            rs = _ref_leaf_spec(key, shape, m, fsdp, policy)
            parts = key.split("/")
            i = _stack_split(parts)
            if i is None:
                assert _full(specs[key], len(shape)) == rs, (arch, key)
                keys.add(key)
                continue
            per_layer = ["/".join(parts[:i] + [str(r)] + parts[i:])
                         for r in range(shape[0])]
            keys.update(per_layer)
            if rs[0] is not None:
                layer_dim += 1
                continue
            if math.prod(shape[1:]) < 1024 <= math.prod(shape):
                small += 1
                assert all(tuple(specs[k]) == () for k in per_layer)
                continue
            for k in per_layer:
                assert port[k] == shape[1:], (arch, k)
                assert _full(specs[k], len(shape) - 1) == rs[1:], (
                    arch, k, specs[k], rs)
        assert keys == set(port), (arch, set(port) ^ keys)
    assert layer_dim == LAYER_DIM[mesh][policy][fsdp]
    assert small == SMALL_LAYER


def test_every_sharded_port_dim_divides_its_axes():
    """The rules' guarantee (the reference's test, on the port's leaves):
    a sharded dim divides by the product of its axes' sizes."""
    for mesh in MESHES.values():
        m = _mesh(mesh)
        sizes = axis_sizes(m)
        for arch in ARCHS:
            _, port = _structs(arch)
            specs = sharding.shard_params(
                {k: _Shaped(s) for k, s in port.items()}, m, fsdp=True)
            for k, shape in port.items():
                for dim, entry in zip(shape, specs[k]):
                    if entry is None:
                        continue
                    axes = entry if isinstance(entry, tuple) else (entry,)
                    n = math.prod(sizes[a] for a in axes)
                    assert dim % n == 0, (arch, k, shape, specs[k])


def test_explain_sharding_lists_shard_params_decisions():
    m = _mesh((4, 4))
    _, port = _structs("deepseek-moe-16b")
    leaves = {k: _Shaped(s) for k, s in port.items()}
    specs = sharding.shard_params(leaves, m, fsdp=True)
    rows = sharding.explain_sharding(leaves, m, fsdp=True, limit=40)
    assert len(rows) == 40
    assert rows == [(k, port[k], specs[k]) for k in list(port)[:40]]


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    class FakeMesh:
        ndim = 3
        mesh_dim_names = ("pod", "data", "model")

    got = sharding.placements(sharding.P(("pod", "data"), None, "model"),
                              FakeMesh())
    assert got == [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements(sharding.P(), FakeMesh()) == [Replicate()] * 3


# ------------------------------------------------------- batch and cache
def _ref_inputs(arch, shape_name):
    return jbuild_model(arch, JModelOpts()).input_specs(JSHAPES[shape_name])


@pytest.mark.parametrize("policy", sharding.POLICIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_sharding_matches_reference(mesh, policy):
    m = _mesh(MESHES[mesh])
    for arch in ARCHS:
        model = build_model(arch, ModelOpts())
        for name in ("train_4k", "prefill_32k"):
            ref = _ref_inputs(arch, name)
            specs = model.input_specs(SHAPES[name])
            if name == "train_4k":
                ref, specs = ref["batch"], specs["batch"]
            want = jsharding.batch_sharding(m, ref, policy)
            got = sharding.batch_sharding(m, specs, policy)
            assert set(got) == set(want)
            for k in want:
                assert tuple(got[k]) == tuple(want[k].spec), (arch, name, k)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_sharding_matches_reference(mesh, shape_name):
    """Against the reference's stacked cache, its leading layer dim
    dropped: the port's cache has one entry a layer."""
    m = _mesh(MESHES[mesh])
    B = SHAPES[shape_name].global_batch
    for arch in ARCHS:
        ref = _ref_inputs(arch, shape_name)["cache"]
        want = flatten_tree(jsharding.cache_sharding(m, ref, B))
        specs = build_model(arch, ModelOpts()).input_specs(
            SHAPES[shape_name])["cache"]
        got = sharding.cache_sharding(m, specs, B)
        n = 0
        for key, spec in want.items():
            spec = tuple(spec.spec)
            parts = key.split("/")
            i = _stack_split(parts)
            if i is None:
                assert tuple(got[key]) == spec, (arch, key)
                n += 1
                continue
            for r in range(flatten_tree(ref)[key].shape[0]):
                k = "/".join(parts[:i] + [str(r)] + parts[i:])
                assert _full(got[k], len(specs[k].shape)) == _full(
                    spec[1:], len(specs[k].shape)), (arch, k)
                n += 1
        assert n == len(got)


def test_mesh_helpers_on_an_abstract_mesh():
    m = _mesh((2, 16, 16))
    assert batch_axes(m) == ("pod", "data") and n_chips(m) == 512


# -------------------------------------------------- collectives and wire
def test_wire_bytes_matches_reference():
    for kinds in ({"all-reduce": 100}, {"all-gather": 160},
                  {"collective-permute": 7},
                  {"all-reduce": 3, "reduce-scatter": 5, "all-to-all": 11,
                   "all-gather": 13, "collective-permute": 17}):
        assert wire_bytes(kinds) == jwire_bytes(kinds)


def test_collective_bytes_sums_records_by_kind():
    out = collective_bytes([("all-reduce", 8, "data"),
                            ("all-reduce", 4, "model"),
                            ("all-gather", 16, None)])
    assert out["all-reduce"] == 12 and out["all-gather"] == 16
    assert out["total"] == 28
    assert out["counts"] == {"all-gather": 1, "all-reduce": 2,
                             "reduce-scatter": 0, "all-to-all": 0,
                             "collective-permute": 0}


# ------------------------------------------------------------ analytic
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in SHAPES:
        shape, jshape = SHAPES[name], JSHAPES[name]
        pairs = [
            (analytic.step_flops(cfg, shape),
             janalytic.step_flops(jcfg, jshape)),
            (analytic.step_flops(cfg, shape, remat=False),
             janalytic.step_flops(jcfg, jshape, remat=False)),
            (analytic.cache_bytes(cfg, shape),
             janalytic.cache_bytes(jcfg, jshape)),
            (dryrun.model_flops(cfg, shape),
             jdryrun.model_flops(jcfg, jshape))]
        for chips, kw in ((256, {}), (512, {"fsdp": True}),
                          (16, {"model_axis": 4, "data_axis": 4,
                                "param_bytes": 2})):
            pairs.append((analytic.step_hbm_bytes(cfg, shape, chips, **kw),
                          janalytic.step_hbm_bytes(jcfg, jshape, chips,
                                                   **kw)))
        for got, want in pairs:
            assert got == pytest.approx(want, rel=1e-12), (name, got, want)
        assert dryrun.applicable(cfg, name) == jdryrun.applicable(jcfg,
                                                                  name)


# --------------------------------------------------------- input_specs
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Shapes and dtypes of every input of every shape's step; the cache
    through checkpoint/convert.py's key mapping (stacked -> per layer)."""
    model = build_model(arch, ModelOpts())
    jmodel = jbuild_model(arch, JModelOpts())
    for name in SHAPES:
        got = flatten_tree(model.input_specs(SHAPES[name]))
        want = flatten_tree(jmodel.input_specs(JSHAPES[name]))
        mapped = {}
        for key, leaf in want.items():
            parts = key.split("/")
            i = _stack_split(parts)
            if i is None:
                mapped[key] = (tuple(leaf.shape), leaf.dtype)
                continue
            for r in range(leaf.shape[0]):
                mapped["/".join(parts[:i] + [str(r)] + parts[i:])] = (
                    tuple(leaf.shape[1:]), leaf.dtype)
        assert set(got) == set(mapped), (name, set(got) ^ set(mapped))
        for k, t in got.items():
            assert t.device.type == "meta", (name, k)
            shape, dtype = mapped[k]
            assert tuple(t.shape) == shape, (name, k, t.shape, shape)
            assert str(t.dtype) == f"torch.{np.dtype(dtype).name}", (
                name, k, t.dtype, dtype)
