"""The port's optimizers (repro_torch.optim) against the JAX package on the
CPU: five steps of adamw (with and without weight decay and a cosine
schedule), sgd with momentum, lion and clip_by_global_norm from the same
params and the same gradients, within 1e-6; plus the pre/shard_update
split of the clip.

Params and gradients are made with numpy from a seed and fed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro_torch import optim

SHAPES = {"layers/0/w": (4, 3), "layers/0/b": (3,), "pi/w": (3, 2),
          "log_std": (2,)}
OPTS = {
    "adamw": lambda m: m.adamw(1e-2),
    "adamw_wd_cosine": lambda m: m.adamw(
        m.cosine_schedule(1e-2, 6, warmup=2, floor=1e-3),
        weight_decay=0.1),
    "sgd_momentum": lambda m: m.sgd(5e-2, momentum=0.9),
    "lion": lambda m: m.lion(1e-3, weight_decay=0.01),
    "clip_adamw": lambda m: m.clip_by_global_norm(m.adamw(1e-2), 0.5),
    "chain_clip_sgd": lambda m: m.chain(m.sgd(1e-2),
                                        lambda o: m.clip_by_global_norm(
                                            o, 0.1)),
}


def _draw(rng):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_five_steps_match_jax(name):
    rng = np.random.default_rng(0)
    p0 = _draw(rng)
    jopt, topt = OPTS[name](jax_optim), OPTS[name](optim)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        g = _draw(rng)
        jp, js = jopt.apply(jp, js, {k: jnp.asarray(v) for k, v in
                                     g.items()})
        tp, ts = topt.apply(tp, ts, {k: torch.tensor(v) for k, v in
                                     g.items()})
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 5
    for moment in ("m", "v", "mu"):
        if isinstance(js.get(moment), dict):
            for k in SHAPES:
                np.testing.assert_allclose(ts[moment][k].numpy(),
                                           np.asarray(js[moment][k]),
                                           atol=1e-6, rtol=1e-6)


def test_clip_split_composes_to_update():
    """update(g, s, p) == shard_update(pre(g), s, p), and the clip scale
    is min(1, max_norm / max(|g|, 1e-9))."""
    rng = np.random.default_rng(1)
    p = {k: torch.tensor(v) for k, v in _draw(rng).items()}
    g = {k: torch.tensor(v) * 10 for k, v in _draw(rng).items()}
    opt = optim.clip_by_global_norm(optim.adamw(1e-2), 1.0)
    s = opt.init(p)
    u1, _ = opt.update(g, s, p)
    u2, _ = opt.shard_update(opt.pre(g), s, p)
    for k in p:
        assert torch.equal(u1[k], u2[k])
    clipped = opt.pre(g)
    assert float(optim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-6)
    small = {k: v * 1e-12 for k, v in g.items()}
    for k in p:
        assert torch.equal(opt.pre(small)[k], small[k])
