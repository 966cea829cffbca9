"""`repro_torch.tracing` on the CPU: spans and counters cost nothing and
keep nothing with no profiler recording; under torch.profiler a tiny
PPO or IMPALA fit and a tiny MoE prefill show every span of the RL loop,
the learner, the prefill, attention and the MoE dispatch, nested as the
program runs them, and the experts' load counter gives the gmm's fill
and the dropped share that a recount from the routing gives; the
grouped matmul's row-tiles record keeps its rows, C and tile only then.
The launchers' `--trace-out` writes the trace and its counters."""
import collections
import contextlib
import dataclasses
import io
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import envs, tracing
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import rl_train, serve
from repro_torch.models import moe
from repro_torch.models.model import ModelOpts, build_model

TRUNK = ModelConfig(name="tiny-trunk", family="dense", n_layers=2,
                    d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab=64,
                    layer_pattern=("attn",))
ITERS, SUPERSTEP, UNROLL, EPOCHS, MINIBATCHES = 2, 2, 3, 2, 2


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty_counters():
    tracing.reset_counters()
    yield
    tracing.reset_counters()


def _fit(algo):
    kw = dict(policy="trunk", trunk_kwargs={"arch": TRUNK, "reduced": False})
    if algo == "ppo":
        kw.update(n_epochs=EPOCHS, n_minibatch=MINIBATCHES)
    cfg = TrainerConfig(algo=algo, iters=ITERS, superstep=SUPERSTEP,
                        n_envs=8, unroll=UNROLL, seed=3, algo_kwargs=kw)
    Trainer(envs.make("cartpole"), cfg, device="cpu").fit()


def _moe_cfg(capacity_factor=1.25):
    cfg = get_config("deepseek-moe-16b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


def _prefill():
    model = build_model(_moe_cfg(), ModelOpts(remat=False, use_kernels=True))
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, "cpu")
    tokens = torch.randint(0, model.cfg.vocab, (1, 24), generator=gen)
    with torch.inference_mode():
        logits, _ = model.prefill(params, tokens)
        serve._next_token(logits, 0.0, None)


RUNS = {"ppo": lambda: _fit("ppo"), "impala": lambda: _fit("impala"),
        "moe_prefill": _prefill}


def _spans(run, tmp_path):
    """{span name: [(ts, end, tid)]} of `run()` under the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = collections.defaultdict(list)
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith("repro_torch."):
            out[e["name"]].append((e["ts"], e["ts"] + e["dur"], e["tid"]))
    return out


def _inside(child, parents):
    a, b, tid = child
    return any(pa <= a and b <= pb and pt == tid for pa, pb, pt in parents)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_no_profiler_no_record_function_and_no_counter(name, monkeypatch,
                                                       one_thread):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(tracing, "record_function", refuse)
    assert tracing.span("repro_torch.x") is tracing.span("repro_torch.y")
    RUNS[name]()
    assert tracing.read_counters() == {}


# {span: (its parents, one of which holds every call; calls)}; calls as a
# function of the run's sizes, None where only "at least one" is fixed
RL = "repro_torch.rl."
PPO_SPANS = {
    RL + "rollout": ((), ITERS),
    RL + "rollout.policy": ((RL + "rollout",), ITERS * UNROLL),
    RL + "rollout.env": ((RL + "rollout",), ITERS * UNROLL),
    RL + "learner": ((), ITERS),
    RL + "learner.targets": ((RL + "learner",), ITERS),
    RL + "learner.loss": ((RL + "learner",), ITERS * EPOCHS * MINIBATCHES),
    RL + "learner.backward": ((RL + "learner",),
                              ITERS * EPOCHS * MINIBATCHES),
    RL + "learner.optimizer": ((RL + "learner",),
                               ITERS * EPOCHS * MINIBATCHES),
    RL + "episodes": ((RL + "learner",), ITERS),
    RL + "sync": ((), ITERS // SUPERSTEP),
    "repro_torch.attention": ((RL + "rollout.policy", RL + "learner.targets",
                               RL + "learner.loss"), None)}
IMPALA_SPANS = dict(
    PPO_SPANS, **{
        RL + "learner.targets": ((RL + "learner.loss",), ITERS),
        RL + "learner.loss": ((RL + "learner",), ITERS),
        RL + "learner.backward": ((RL + "learner",), ITERS),
        RL + "learner.optimizer": ((RL + "learner",), ITERS)})
M = "repro_torch.moe"
MOE_SPANS = {   # the reduced model: one MoE layer after a dense one
    "repro_torch.lm.prefill": ((), 1),
    "repro_torch.lm.sample": ((), 1),
    "repro_torch.attention": (("repro_torch.lm.prefill",), 2),
    M: (("repro_torch.lm.prefill",), 1),
    M + ".route": ((M,), 1),
    M + ".dispatch": ((M,), 1),
    M + ".experts": ((M,), 3),
    M + ".combine": ((M,), 1),
    M + ".shared": ((M,), 1)}
EXPECTED = {"ppo": PPO_SPANS, "impala": IMPALA_SPANS,
            "moe_prefill": MOE_SPANS}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_spans_under_the_profiler_nest_as_the_program_runs(name, tmp_path,
                                                           one_thread):
    got = _spans(RUNS[name], tmp_path)
    want = EXPECTED[name]
    assert set(got) == set(want)
    for span, (parents, calls) in want.items():
        if calls is None:
            assert got[span], span
        else:
            assert len(got[span]) == calls, span
        if parents:
            held = [iv for p in parents for iv in got[p]]
            assert all(_inside(c, held) for c in got[span]), span
        else:   # a top span: nothing of the program holds it
            others = [iv for s, ivs in got.items() if s != span
                      for iv in ivs]
            assert not any(_inside(c, others) for c in got[span]), span


def test_the_kernel_backward_runs_under_its_span(monkeypatch, tmp_path):
    """`_FlashAttention.backward` (CUDA only: here with a stand-in for the
    kernel) calls the backward kernel inside `repro_torch.attention.
    backward`."""
    B, S, KVH, G, D = 2, 3, 1, 2, 4
    q = torch.randn(B, KVH * G, S, D)
    kt, vt = torch.randn(B, KVH, S, D), torch.randn(B, KVH, S, D)
    o, lse = torch.randn(B, KVH * G, S, D), torch.randn(B, KVH * G, S)
    seen = []

    def bwd(q, k, v, o, lse, do, causal, window):
        seen.append(True)
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    monkeypatch.setattr(flash_ops, "flash_attention_bwd", bwd)
    ctx = type("Ctx", (), dict(saved_tensors=(q, kt, vt, o, lse),
                               causal=True, window=0))()
    dout = torch.randn(B, S, KVH, G, D)
    got = _spans(lambda: flash_ops._FlashAttention.backward(ctx, dout),
                 tmp_path)
    assert seen and len(got["repro_torch.attention.backward"]) == 1


def _router_leaning_to_expert_0(cfg, T, seed=0):
    """Params of one MoE FFN and (T, d) inputs that send most tokens to
    expert 0, so that its load passes the capacity."""
    m, d = cfg.moe, cfg.d_model
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g) * 0.1
    fs = m.d_ff * m.n_shared
    p = {"router": r(d, m.n_experts), "wi": r(m.n_experts, d, m.d_ff),
         "wg": r(m.n_experts, d, m.d_ff), "wo": r(m.n_experts, m.d_ff, d),
         "shared": {"wi": r(d, fs), "wg": r(d, fs), "wo": r(fs, d)}}
    lean = p["router"][:, 0] / p["router"][:, 0].norm()
    x = torch.randn(1, T, d, generator=g) + 1.5 * lean
    return p, x


@pytest.mark.parametrize("capacity_factor,drops", [(1.25, True),
                                                   (16.0, False)])
def test_expert_load_matches_a_recount_from_the_routing(capacity_factor,
                                                         drops):
    """Each dispatch's record: the experts' loads as `_route`'s top-k
    gives them, the capacity C and the T·K assignments, from which the
    fill, sum(min(load, C)) / (E·C), and the dropped share follow."""
    cfg, T = _moe_cfg(capacity_factor), 64
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    p, x = _router_leaning_to_expert_0(cfg, T)
    with profile(activities=[ProfilerActivity.CPU]):
        moe.apply_moe(cfg, p, x)
    (rec,) = tracing.read_counters()["repro_torch.moe.expert_load"]
    _, _, topi = moe._route(cfg, p, x.reshape(T, -1))
    load = torch.bincount(topi.reshape(-1), minlength=E).tolist()
    C = max(8, round(T * K / E * capacity_factor))
    assert rec == {"load": load, "capacity": C, "assigned": T * K}
    assert (sum(max(n - C, 0) for n in load) > 0) is drops


def test_gmm_row_tiles_counter_records_only_while_profiling():
    """What a launch with `rows` records (kernels/gmm/kernel.py, on the
    card): the device counts, C and the row tile, only under a profiler;
    the counts reach the host only in `read_counters`."""
    from repro_torch.kernels.gmm import kernel as gmm_kernel
    rows = torch.tensor([0, 64, 65, 300])
    gmm_kernel.count_row_tiles(rows, 202, 64)
    assert tracing.read_counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        gmm_kernel.count_row_tiles(rows, 202, 64)
    assert tracing.read_counters() == {"repro_torch.gmm.row_tiles": [
        {"rows": [0, 64, 65, 300], "capacity": 202, "tile": 64}]}


def test_read_counters_moves_tensors_to_host_lists():
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("c", {"a": torch.tensor([1, 2]), "b": 3})
        tracing.count("c", torch.tensor([[0.5]]))
        tracing.count("d", 7)
    assert tracing.read_counters() == {
        "c": [{"a": [1, 2], "b": 3}, [[0.5]]], "d": [7]}
    tracing.reset_counters()
    assert tracing.read_counters() == {}


@pytest.mark.parametrize("launcher", ["rl_train", "serve"])
def test_trace_out_writes_the_trace_and_its_counters(launcher, tmp_path,
                                                     one_thread):
    path = tmp_path / "out.json"
    with contextlib.redirect_stdout(io.StringIO()):
        if launcher == "rl_train":
            rl_train.main(["--algo", "ppo", "--device", "cpu", "--iters",
                           "4", "--superstep", "2", "--n-envs", "8",
                           "--unroll", "4", "--trace-out", str(path)])
            top = ("repro_torch.rl.rollout", 2)
        else:
            serve.main(["--reduced", "--device", "cpu", "--arch",
                        "deepseek-moe-16b", "--use-kernels", "--gen-len",
                        "2", "--trace-out", str(path)])
            top = ("repro_torch.lm.prefill", 1)
    names = collections.Counter(
        e["name"] for e in json.loads(path.read_text())["traceEvents"]
        if e.get("cat") == "user_annotation")
    assert names[top[0]] == top[1]       # the last superstep, one prefill
    counters = json.loads((tmp_path / "out.counters.json").read_text())
    if launcher == "serve":
        (rec,) = counters["repro_torch.moe.expert_load"]
        assert sum(rec["load"]) == rec["assigned"] == 4 * 32 * 2
    else:
        assert counters == {}


class _FakeProfile:
    """torch.profiler.profile's stand-in: one kernel of 5 µs a call, its
    launch, and a span's device-side range over it (a user annotation
    with a CUDA device type, as Kineto reports `record_function` ranges
    on the card)."""

    def __init__(self, *a, **k):
        self.calls = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _events(self):
        from types import SimpleNamespace as E
        cuda, cpu = (torch.autograd.DeviceType.CUDA,
                     torch.autograd.DeviceType.CPU)
        span = lambda us: E(time_range=E(elapsed_us=lambda: us))
        return [E(device_type=cpu, name="cudaLaunchKernel",
                  key="cudaLaunchKernel", count=1, is_user_annotation=False,
                  self_device_time_total=0.0, **vars(span(1.0))),
                E(device_type=cuda, name="k", key="k", count=1,
                  is_user_annotation=False, self_device_time_total=5.0,
                  **vars(span(5.0))),
                E(device_type=cuda, name="repro_torch.moe", count=1,
                  key="repro_torch.moe", is_user_annotation=True,
                  self_device_time_total=5.0, **vars(span(5.0)))]

    def key_averages(self):
        return self._events()

    def events(self):
        return self._events()


@pytest.mark.parametrize("window", ["kernel_us", "device_window"])
def test_profile_windows_count_kernels_not_span_ranges(window, monkeypatch):
    """The port's profile windows (`launch/profiling`) read device time
    by kernel; a span's device-side range covers kernels and is not one."""
    from repro_torch.launch import profiling
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    if window == "kernel_us":
        times, launches = profiling.kernel_us(lambda: None, calls=1)
        assert times == {"k": 5.0} and launches == {"k": 1.0}
    else:
        out = profiling.device_window(lambda: None, 1)
        assert out["device_ms_per_call"] == pytest.approx(5e-3)
        assert out["device_ops_per_call"] == 1
        assert [k["name"] for k in out["top_device_us_per_call"]] == ["k"]
