"""The benchmark's plain references against the port's CPU path at
reduced widths: the same float32 arithmetic in another order, so the
tolerances are a few float32 roundings of the values compared."""
import pytest
import torch

from bench import weights
from bench.drivers.rl_train import program_config
from bench.refs import rl as ref
from bench.refs import transformer as tref

TRUNK = dict(name="tiny-trunk", family="dense", n_layers=2, d_model=32,
             n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab=64,
             layer_pattern=["attn"], norm="rmsnorm", rope_theta=10000.0)
MOE = dict(name="tiny-moe", family="moe", n_layers=3, d_model=32, n_heads=2,
           n_kv_heads=2, head_dim=16, d_ff=64, vocab=96,
           layer_pattern=["attn"], norm="rmsnorm", rope_theta=10000.0,
           moe=dict(n_experts=8, top_k=2, d_ff=16, n_shared=1, every=1,
                    first_dense=1, capacity_factor=1.25, aux_loss_coef=0.01))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trunk_policy():
    from repro_torch import envs
    from repro_torch.core.networks import TrunkPolicy
    return TrunkPolicy.for_spec(envs.make("cartpole").spec,
                                arch=program_config(TRUNK), reduced=False,
                                use_kernels=True, device="cpu")


def test_trunk_forward_matches_the_port():
    policy = trunk_policy()
    params = weights.draw(weights.program_shapes(policy), 3, "cpu")
    obs = torch.randn(64, 4, generator=torch.Generator().manual_seed(1))
    pi, v = policy.apply(params, obs)
    rpi, rv = ref.policy(params, obs, TRUNK)
    torch.testing.assert_close(rpi, pi, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rv, v, rtol=1e-5, atol=1e-5)


def test_cartpole_step_matches_the_port():
    from repro_torch import envs
    env = envs.make("cartpole")
    g = torch.Generator().manual_seed(4)
    state = env.reset(g, 256)
    state["s"] = state["s"] * 40          # some past the limits
    state["t"] = torch.randint(190, 200, (256,), generator=g,
                               dtype=torch.int32)
    action = torch.randint(0, 2, (256,), generator=g, dtype=torch.int32)
    new, obs, reward, done = env.step(state, action)
    s, r, d, t = ref.cartpole_step(state["s"], state["t"].long(), action)
    torch.testing.assert_close(s, obs, rtol=1e-6, atol=1e-6)
    assert torch.equal(r, reward) and torch.equal(d, done)
    assert d.any() and not d.all()


def test_gae_and_vtrace_match_the_port():
    from repro_torch.core.advantages import gae
    from repro_torch.core.vtrace import vtrace
    g = torch.Generator().manual_seed(5)
    T, B = 7, 5
    r, v = torch.rand(T, B, generator=g), torch.randn(T, B, generator=g)
    done = torch.rand(T, B, generator=g) < 0.2
    boot = torch.randn(B, generator=g)
    for a, b in zip(gae(r, v, done, boot, 0.99, 0.95),
                    ref.gae(r, v, done, boot, 0.99, 0.95)):
        torch.testing.assert_close(b, a)
    log_rhos = 0.3 * torch.randn(T, B, generator=g)
    disc = 0.99 * (1 - done.float())
    for a, b in zip(vtrace(log_rhos, disc, r, v, boot, 1.0, 1.0),
                    ref.vtrace(log_rhos, disc, r, v, boot, 1.0, 1.0)):
        torch.testing.assert_close(b, a)


def test_adam_with_clipping_matches_the_port():
    from repro_torch.optim import adamw, clip_by_global_norm
    g = torch.Generator().manual_seed(6)
    params = {"a": torch.randn(3, 4, generator=g),
              "b": torch.randn(5, generator=g)}
    opt = clip_by_global_norm(adamw(3e-4), 0.5)
    state = opt.init(params)
    mine = ref.Adam(params, 3e-4, 0.5)
    p, q = params, params
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p.items()}
        p, state = opt.apply(p, state, grads)
        q = mine.apply(q, grads)
    for k in params:
        torch.testing.assert_close(q[k], p[k], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(mine.m[k], state["m"][k])


@pytest.mark.parametrize("ids", [(0, 1), (7, 1), (2, 3, 9)])
def test_stream_seed_matches_the_training_loop(ids):
    from repro_torch.core.networks import stream_seed
    for seed in (0, 2 ** 31 + 3, 2 ** 62 + 11):
        assert ref.stream_seed(seed, *ids) == stream_seed(seed, *ids)


def lm(cfg):
    from repro_torch.models.model import ModelOpts, build_model
    model = build_model(program_config(cfg), ModelOpts(
        dtype="float32", remat=False, use_kernels=True))
    return model, weights.draw(weights.program_shapes(model), 8, "cpu")


@pytest.mark.parametrize("length", [5, 33])
def test_prefill_logits_match_the_port(length):
    model, params = lm(MOE)
    tokens = torch.randint(0, MOE["vocab"], (1, length),
                           generator=torch.Generator().manual_seed(length))
    with torch.inference_mode():
        logits, _ = model.prefill(params, tokens)
    want = tref.last_logits(params, tokens, tref.with_head_dim(MOE))
    torch.testing.assert_close(want, logits[0, -1], rtol=1e-4, atol=1e-5)


def test_moe_capacity_drops_match_the_port():
    from repro_torch.models import moe
    cfg = dict(MOE, moe=dict(MOE["moe"], capacity_factor=0.5))
    pcfg = program_config(cfg)
    _, params = lm(cfg)
    p = tref.sub(params, "stack/0/t0")["ffn"]
    x = torch.randn(1, 64, 32, generator=torch.Generator().manual_seed(9))
    got, _ = moe.apply_moe(pcfg, p, x, use_kernels=True)
    want = tref.moe(p, x[0], cfg["moe"])
    torch.testing.assert_close(want, got[0], rtol=1e-5, atol=1e-6)
    # the capacity binds: some expert was routed more than it keeps
    gates = torch.softmax(x[0] @ p["router"], -1)
    top = torch.sort(gates, dim=-1, descending=True, stable=True)[1][:, :2]
    assert torch.bincount(top.reshape(-1), minlength=8).max() > \
        tref.capacity(64, cfg["moe"])
