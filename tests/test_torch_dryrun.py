"""The port's multi-pod dry-run (repro_torch.launch.dryrun) on reduced
configs at small meshes, on the CPU. A dry-run makes its process a rank
of a fake process group of the mesh's world size, so every case runs in
a subprocess of its own (one per world size, started together); this
process never initialises torch.distributed."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import ModelOpts, build_model

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_HEAD = """
import json
import torch
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.comm_analysis import collective_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import ModelOpts
out = {}
KEYS = ("status", "error", "traceback", "collective_bytes",
        "collective_bytes_by_axis", "bottleneck", "chips")
def case(name, arch, shape, **kw):
    r = dryrun.dryrun_one(get_config(arch).reduced(), shape, save=False,
                          **kw)
    out[name] = {k: r.get(k) for k in KEYS}
"""

# The cases, one script per world size. The attention's kv block is
# raised where the sequence is long so a meta run issues fewer ops;
# placements and the collectives of each op are unchanged by it.
_SCRIPTS = {
    "w4": """
case("pure_dp", "smollm-360m", "train_4k", mesh_shape=(2, 2),
     policy="pure_dp")
case("rwkv_long", "rwkv6-1.6b", "long_500k", mesh_shape=(2, 2))
# act_batch_axes: each stack super-block's input, from replicated tokens
from torch.distributed.tensor import Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.models.model import build_model
mesh = make_production_mesh(shape=(2, 2))
cfg = get_config("smollm-360m").reduced()
seen = {}
for axes in ((), ("data",)):
    model = build_model(cfg, ModelOpts(act_batch_axes=axes))
    got = seen.setdefault(",".join(axes), [])
    for sb in model.stack:
        sb["t0"].register_forward_pre_hook(
            lambda m, args: got.append([type(p).__name__ + str(
                getattr(p, "dim", "")) for p in args[0].placements]))
    rep = [Replicate(), Replicate()]
    params = {k.replace(".", "/"): distribute_tensor(
        torch.empty(t.shape, device="meta"), mesh, rep)
        for k, t in model.named_parameters()}
    tokens = distribute_tensor(
        torch.empty((8, 17), dtype=torch.int32, device="meta"), mesh, rep)
    with implicit_replication():
        model.loss(params, {"tokens": tokens})
out["act_batch"] = seen
""",
    "w4b": """
case("deepseek_decode", "deepseek-moe-16b", "decode_32k", mesh_shape=(2, 2))
case("whisper_prefill", "whisper-base", "prefill_32k", mesh_shape=(2, 2),
     model_opts=ModelOpts(dtype="bfloat16", remat=True, block_k=32768))
""",
    "w2": """
# one dense FFN block of the model, laid out by the plan, on a replicated
# input, its output then made whole
from torch.distributed.tensor import Replicate
from repro_torch.launch.sharding import P, shard_params
from repro_torch.models.layers import apply_mlp
from repro_torch.models.model import build_model
mesh = make_production_mesh(shape=(1, 2))
model = build_model(get_config("smollm-360m").reduced(), ModelOpts())
struct = dryrun._param_struct(model, "float32")
specs = shard_params({k: torch.empty(s, device="meta")
                      for k, (s, _) in struct.items()}, mesh)
params = dryrun._distribute(struct, specs, mesh)
pre = "stack/0/t0/ffn/"
ffn = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
x = dryrun._meta_dtensor((256, 4096, 128), torch.bfloat16, P(), mesh)
def block(x):
    return apply_mlp(ffn, x).redistribute(mesh, [Replicate(), Replicate()])
_, rec = dryrun._run(block, (x,), mesh)
out["ffn"] = {"specs": {k[len(pre):]: list(v) for k, v in specs.items()
                        if k.startswith(pre)}, "records": rec.records}
""",
    "w8": """
case("multi_pod", "gemma3-1b", "decode_32k", multi_pod=True,
     mesh_shape=(2, 2, 2))
# the reduced jamba's 4 query heads over a 4-way model axis, split into
# (2 kv heads, 2 groups)
case("jamba_decode", "jamba-v0.1-52b", "decode_32k", mesh_shape=(2, 4))
case("jamba_long", "jamba-v0.1-52b", "long_500k", mesh_shape=(2, 4))
""",
    "w4c": """
# the rules of the dry-run's own that torch 2.11 needs, one op each on
# a small fake mesh, and the training step that flips (cumsum's backward)
case("rwkv_train", "rwkv6-1.6b", "train_4k", mesh_shape=(2, 2))
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
from torch.distributed.tensor._op_schema import OpSchema, OpSpec, OpStrategy
from repro_torch.launch.sharding import P
dryrun._register_rules()
names = lambda t: [str(p) for p in t.placements]
m22 = make_production_mesh(shape=(2, 2))
m14 = make_production_mesh(shape=(1, 4))
x = dryrun._meta_dtensor((4, 6, 8), torch.float32, P("data", None, "model"),
                         m22)
(keep, cut), rec = dryrun._run(
    lambda x: (torch.flip(x, [1]), torch.flip(x, [-1])), (x,), m22)
out["flip"] = {"keep": names(keep), "cut": names(cut),
               "records": rec.records}
split = {}
for label, mesh in (("wider", m14), ("divides", m22)):
    q = dryrun._meta_dtensor((2, 8, 4, 16), torch.bfloat16,
                             P(None, None, "model", None), mesh)
    o, rec = dryrun._run(lambda q: q.reshape(2, 8, 2, 2, 16), (q,), mesh)
    split[label] = {"placements": names(o), "shape": list(o.shape),
                    "records": rec.records}
out["split"] = split
def spec(shape, placements):
    t = torch.empty(shape, device="meta")
    return DTensorSpec(m22, tuple(placements),
                       tensor_meta=TensorMeta(t.shape, t.stride(), t.dtype))
def follow_first(op_schema):
    # torch 2.11's linear pointwise answer for an add: it follows the
    # first operand, and asks the second for the first's partial sum
    a, b = (arg.strategies[0].output_spec for arg in op_schema.args_schema)
    return OpStrategy([OpSpec(spec((8, 1, 16), a.placements), [
        a, spec(b.shape, [Replicate(), Partial()])], [[0.0], [0.0]])])
add = {}
for label, bias in (("sharded", Shard(0)), ("replicated", Replicate())):
    a = spec((8, 1, 1), [Shard(0), Partial()])
    b = spec((16,), [Replicate(), bias])
    got = dryrun.keep_shard(follow_first)(OpSchema(
        torch.ops.aten.add.Tensor, (OpStrategy([OpSpec(a)]),
                                    OpStrategy([OpSpec(b)])), {}))
    s = got.strategies[0]
    add[label] = {"out": [str(p) for p in s.output_specs.placements],
                  "inputs": [[str(p) for p in t.placements]
                             for t in s.input_specs]}
out["add"] = add
""",
}


@pytest.fixture(scope="module")
def runs():
    """The scripts' processes, started together; `result(name)` waits for
    one and returns what it printed."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_HEAD) + body
         + '\nprint("RESULT " + json.dumps(out))\n'],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, body in _SCRIPTS.items()}
    done = {}

    def result(name):
        if name not in done:
            stdout, stderr = procs[name].communicate(timeout=600)
            assert procs[name].returncode == 0, stderr[-3000:]
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")][-1]
            done[name] = json.loads(line[len("RESULT "):])
        return done[name]

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _ok(rec):
    assert rec["status"] == "ok", (rec.get("error"), rec.get("traceback"))


def _n_params(arch):
    model = build_model(get_config(arch).reduced(), ModelOpts())
    return sum(t.numel() for t in model.parameters())


def test_pure_dp_all_reduces_the_f32_gradient_once_an_axis(runs):
    """pure_dp replicates every param and shards the batch over both
    axes: the only collective is the gradient's all-reduce, which DTensor
    runs once over each mesh axis (a partial sum over (data, model) is
    reduced one axis at a time) on the f32 gradient, 4·P bytes."""
    rec = runs("w4")["pure_dp"]
    _ok(rec)
    four_p = 4 * _n_params("smollm-360m")
    by_axis = rec["collective_bytes_by_axis"]
    assert set(by_axis) == {"data", "model"}
    for axis, nbytes in by_axis.items():
        assert abs(nbytes - four_p) <= 64, (axis, nbytes, four_p)
    cb = rec["collective_bytes"]
    assert cb["all-reduce"] == cb["total"]
    for kind in ("all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        assert cb[kind] == 0 and cb["counts"][kind] == 0, kind


def test_baseline_ffn_all_reduce_derived_from_the_plan(runs):
    """Reduced smollm (d 128, d_ff 128) under baseline at (data 1,
    model 2), one dense FFN block on a replicated (B, S, d) bf16 input.
    The plan shards wi and wg by columns and wo by rows over `model`
    (checked), so h = silu(x·wg)·(x·wi) is sharded on f with no
    collective and h·wo is a partial sum: making the block's output
    whole is exactly one all-reduce on `model` of B·S·d bf16 bytes.
    (The whole forward's count is DTensor's to choose: it reduces each
    partial sum by an all-reduce or a reduce-scatter, by its own cost
    model, op by op.)"""
    out = runs("w2")["ffn"]
    assert out["specs"] == {"wi": [None, "model"], "wg": [None, "model"],
                            "wo": ["model", None]}
    assert out["records"] == [["all-reduce", 256 * 4096 * 128 * 2,
                               "model"]]


@pytest.mark.parametrize("name,script", [
    ("deepseek_decode", "w4b"), ("whisper_prefill", "w4b"),
    ("rwkv_long", "w4"), ("multi_pod", "w8")])
def test_reduced_cases_are_ok(runs, name, script):
    """The MoE decode (its searchsorted rule), the encoder-decoder
    prefill, the recurrent 500k decode and a multi-pod decode (gemma3's
    local and global attention over (pod, data, model); a train step
    takes ~45 s to trace on an 8-core CPU, and chip_smoke.py runs one
    at full width)."""
    rec = runs(script)[name]
    _ok(rec)
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    if name == "multi_pod":
        assert rec["chips"] == 8


@pytest.mark.parametrize("name,script", [
    ("rwkv_train", "w4c"), ("jamba_decode", "w8"), ("jamba_long", "w8")])
def test_cases_torch_2_11_refused_are_ok(runs, name, script):
    """The pairs the `--all` sweep found erroring on torch 2.11 (the card
    host's), reduced: RWKV-6's training step (cumsum's backward flips)
    and jamba's head split over a model axis wider than its kv heads
    (the reduced config's 2 over 4). On this torch they ran before the
    rules too; chip_smoke.py holds them on 2.11 at full width."""
    _ok(runs(script)[name])


def test_flip_keeps_the_shards_of_the_dims_it_does_not_flip(runs):
    """A (4, 6, 8) tensor sharded on dims 0 and 2 over (data, model):
    flipping dim 1 keeps both shards and moves nothing; flipping dim 2
    leaves it unsharded."""
    flip = runs("w4c")["flip"]
    assert flip["keep"] == ["S(0)", "S(2)"]
    assert not [r for r in flip["records"] if r[2] == "data"]
    assert flip["cut"][0] == "S(0)"
    assert flip["cut"][1] != "S(2)"


def test_head_split_wider_than_the_kv_heads_gathers_first(runs):
    """(2, 8, 4 heads, 16) bf16 sharded on heads, split into (2, 2): over
    a 4-way model axis the first part (2) cannot carry the shard, so the
    view runs on the heads gathered, one all-gather of the whole 2048
    bytes on `model`, counted; over a 2-way axis it divides, and the
    output keeps the shard on the kv-head dim with no collective."""
    split = runs("w4c")["split"]
    assert split["wider"] == {"placements": ["R", "R"],
                              "shape": [2, 8, 2, 2, 16],
                              "records": [["all-gather", 2048, "model"]]}
    assert split["divides"] == {"placements": ["R",
                                               "S(2)"],
                                "shape": [2, 8, 2, 2, 16], "records": []}


def test_add_offers_no_partial_sum_of_a_sharded_operand(runs):
    """Jamba's decode add on torch 2.11: a (8, 1, 1) partial sum over
    `model` plus a (16,) bias sharded over `model`. Where DTensor asks
    the sharded bias for a partial sum (which 2.11 cannot make), the
    rule keeps the bias's shard on the output's last dim and reduces
    the partial operand; a replicated bias keeps DTensor's answer (a
    partial sum is reachable from it)."""
    add = runs("w4c")["add"]
    assert add["sharded"] == {
        "out": ["S(0)", "S(2)"],
        "inputs": [["S(0)", "R"],
                   ["R", "S(0)"]]}
    assert add["replicated"] == {
        "out": ["S(0)", "P(sum)"],
        "inputs": [["S(0)", "P(sum)"],
                   ["R", "P(sum)"]]}


def test_act_batch_axes_reshards_each_superblock_input(runs):
    """From replicated tokens, `act_batch_axes=("data",)` hands every
    stack super-block its input sharded on the batch over `data` (and
    replicated over `model`); unset, the input stays replicated."""
    seen = runs("w4")["act_batch"]
    repeats = build_model(get_config("smollm-360m").reduced()).repeats
    assert seen["data"] == [["Shard0", "Replicate"]] * repeats
    assert seen[""] == [["Replicate", "Replicate"]] * repeats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_batch_axes_leaves_plain_tensors_alone(dtype):
    cfg = get_config("smollm-360m").reduced()
    gen = torch.Generator().manual_seed(0)
    base = build_model(cfg, ModelOpts(dtype=dtype))
    params = base.init(gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 9), generator=gen)
    want, _ = base.loss(params, {"tokens": tokens})
    anchored = build_model(cfg, ModelOpts(dtype=dtype,
                                          act_batch_axes=("data",)))
    got, _ = anchored.loss(params, {"tokens": tokens})
    assert torch.equal(got, want)


def test_this_process_never_initialises_distributed(runs):
    runs("w8")
    import repro_torch.launch.dryrun  # noqa: F401 — importing starts nothing
    assert not torch.distributed.is_initialized()


def test_one_process_refuses_a_second_world_size():
    """make_production_mesh initialises the fake group of its world size
    and raises, naming the fix, when a group of another size exists."""
    script = textwrap.dedent("""
        from repro_torch.launch.mesh import make_production_mesh
        make_production_mesh(shape=(2, 2))
        make_production_mesh(shape=(2, 2))   # same world: fine
        try:
            make_production_mesh(shape=(2, 2, 2))
        except RuntimeError as e:
            print("RAISED", e)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "RAISED a process group of world size 4" in r.stdout


_FULL_CASES = [("smollm-360m", "train_4k", (4, 4)),
               ("gemma3-1b", "decode_32k", (4, 4)),
               ("rwkv6-1.6b", "long_500k", (4, 4)),
               ("whisper-base", "prefill_32k", (4, 4)),
               ("smollm-360m", "train_4k", (2, 2, 2))]


@pytest.mark.slow
def test_full_width_cases_beside_the_reference():
    """The reference's five full-width cases through both packages (the
    JAX package in its own 16-device XLA_FLAGS subprocess), printing
    each kind's per-device collective bytes side by side. Gates on
    status only: XLA's partitioner and DTensor (with the dry-run's
    einsum partitioner and op rules) choose different collectives."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    env.pop("XLA_FLAGS", None)
    jax_script = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
        import json, sys
        from repro.launch.dryrun import dryrun_one
        out = []
        for arch, shape, mesh in json.loads(sys.argv[1]):
            r = dryrun_one(arch, shape, mesh_shape=tuple(mesh),
                           multi_pod=len(mesh) == 3, save=False)
            out.append({k: r.get(k) for k in (
                "status", "error", "collective_bytes",
                "collective_bytes_corrected")})
        print("RESULT " + json.dumps(out))
    """)
    port_script = textwrap.dedent("""
        import json, sys
        from repro_torch.launch.dryrun import dryrun_one
        out = []
        for arch, shape, mesh in json.loads(sys.argv[1]):
            r = dryrun_one(arch, shape, mesh_shape=tuple(mesh),
                           multi_pod=len(mesh) == 3, save=False)
            out.append({k: r.get(k) for k in (
                "status", "error", "collective_bytes",
                "collective_bytes_corrected")})
        print("RESULT " + json.dumps(out))
    """)
    groups = [[c for c in _FULL_CASES if len(c[2]) == 2],
              [c for c in _FULL_CASES if len(c[2]) == 3]]
    runs = [(script, group) for script in (jax_script, port_script)
            for group in ([_FULL_CASES] if script is jax_script
                          else groups)]
    results = []
    for script, group in runs:
        r = subprocess.run([sys.executable, "-c", script, json.dumps(group)],
                           capture_output=True, text=True, env=env,
                           timeout=3600)
        assert r.returncode == 0, r.stderr[-3000:]
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT ")][-1]
        results.append(json.loads(line[len("RESULT "):]))
    ref, port = results[0], results[1] + results[2]
    for case, jr, tr in zip(_FULL_CASES, ref, port):
        assert jr["status"] == "ok", (case, jr["error"])
        assert tr["status"] == "ok", (case, tr["error"])
        kinds = [k for k in jr["collective_bytes"] if k not in (
            "total", "counts")]
        print(case, "reference HLO (scan-corrected total "
              f"{jr['collective_bytes_corrected']}):",
              {k: jr["collective_bytes"][k] for k in kinds},
              "port:", {k: tr["collective_bytes"][k] for k in kinds})
