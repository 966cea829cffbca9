"""The port's replay buffers (repro_torch.core.replay) on the CPU against
repro.core.replay: ring writes with wraparound and n > capacity, max-
priority inserts, `update_priorities`, draws from an empty buffer, and
the three samplers (uniform, legacy categorical, fused Gumbel-top-k) fed
the reference's own noise. Integer state exact, floats within
rtol = atol = 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.replay import PrioritizedReplay as JaxPrioritized
from repro.core.replay import UniformReplay as JaxUniform
from repro_torch.core.replay import (PrioritizedReplay, UniformReplay,
                                     gumbel_noise)

TOL = dict(atol=1e-5, rtol=1e-5)


def _batch(n, seed):
    """n transitions as numpy arrays, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, 3)).astype(np.float32),
            "action": rng.integers(0, 4, n).astype(np.int32),
            "done": rng.random(n) < 0.3}


def _example():
    return {"obs": np.zeros(3, np.float32), "action": np.zeros((), np.int32),
            "done": np.zeros((), bool)}


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _assert_state(port, ref):
    for k in ("ptr", "size"):
        assert int(port[k]) == int(ref[k]), k
    for k, v in ref["store"].items():
        np.testing.assert_array_equal(port["store"][k].numpy(), np.asarray(v))
    if "prio" in ref:
        np.testing.assert_allclose(port["prio"].numpy(),
                                   np.asarray(ref["prio"]), **TOL)


def _fill(cap, sizes, fused=True, priorities=False):
    """The same add_batch sequence into the port's and JAX's buffer."""
    port, ref = (PrioritizedReplay(cap, fused=fused),
                 JaxPrioritized(cap, fused=fused))
    ps, rs = port.init(_t(_example())), ref.init(_j(_example()))
    for i, n in enumerate(sizes):
        b = _batch(n, seed=i)
        pr = (np.random.default_rng(100 + i).random(n).astype(np.float32)
              + 0.5) if priorities else None
        ps = port.add_batch(ps, _t(b), None if pr is None
                            else torch.tensor(pr))
        rs = ref.add_batch(rs, _j(b), None if pr is None else jnp.asarray(pr))
    return port, ref, ps, rs


@pytest.mark.parametrize("sizes", [(5,), (5, 5), (3, 7, 6), (11,),
                                   (2, 13)])
def test_ring_writes_match_jax(sizes):
    """Wraparound, and n > capacity keeping only the last capacity items,
    for both buffers; the prioritized one with explicit priorities too."""
    cap = 8
    uport, uref = UniformReplay(cap), JaxUniform(cap)
    us, ur = uport.init(_t(_example())), uref.init(_j(_example()))
    for i, n in enumerate(sizes):
        b = _batch(n, seed=i)
        us, ur = uport.add_batch(us, _t(b)), uref.add_batch(ur, _j(b))
        _assert_state(us, ur)
    for priorities in (False, True):
        *_, ps, rs = _fill(cap, sizes, priorities=priorities)
        _assert_state(ps, rs)


def test_n_above_capacity_keeps_the_last_items():
    port = UniformReplay(4)
    b = _batch(11, seed=0)
    st = port.add_batch(port.init(_t(_example())), _t(b))
    np.testing.assert_array_equal(st["store"]["obs"].numpy(),
                                  b["obs"][[8, 9, 10, 7]])
    assert int(st["ptr"]) == 11 % 4 and int(st["size"]) == 4


def test_max_priority_inserts_and_update_priorities_match_jax():
    port, ref, ps, rs = _fill(16, (6,))
    idx = np.array([0, 3, 5], np.int32)
    td = np.array([2.5, -0.25, 4.0], np.float32)
    ps = port.update_priorities(ps, torch.tensor(idx), torch.tensor(td))
    rs = ref.update_priorities(rs, jnp.asarray(idx), jnp.asarray(td))
    _assert_state(ps, rs)
    assert float(ps["prio"][5]) == pytest.approx(4.0 + 1e-6)
    b = _batch(4, seed=9)
    ps, rs = port.add_batch(ps, _t(b)), ref.add_batch(rs, _j(b))
    _assert_state(ps, rs)
    np.testing.assert_allclose(ps["prio"][6:10].numpy(), 4.0 + 1e-6)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("sizes", [(5,), (9, 9), (30,)])
def test_prioritized_draw_with_jax_noise_matches_jax(fused, sizes):
    """The same key's Gumbel noise: (C,) for the fused draw
    (replay.py:117), (n, C) for the legacy categorical draw (what
    jax.random.categorical adds to the logits)."""
    cap, n = 16, 6
    port, ref, ps, rs = _fill(cap, sizes, fused=fused, priorities=True)
    key = jax.random.PRNGKey(len(sizes))
    g = jax.random.gumbel(key, (cap,) if fused else (n, cap))
    batch, idx, w = port.sample_with(ps, torch.tensor(np.asarray(g)), n)
    jbatch, jidx, jw = ref.sample(rs, key, n)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v))


def test_uniform_draw_matches_jax_indices():
    """floor(u·N) with u = (i + 0.5) / N lands on JAX's randint draw i."""
    cap, n = 16, 10
    port, ref = UniformReplay(cap), JaxUniform(cap)
    b = _batch(7, seed=0)
    ps = port.add_batch(port.init(_t(_example())), _t(b))
    rs = ref.add_batch(ref.init(_j(_example())), _j(b))
    key = jax.random.PRNGKey(3)
    jbatch, jidx = ref.sample(rs, key, n)
    u = (np.asarray(jidx, np.float32) + 0.5) / 7
    batch, idx = port.sample_with(ps, torch.tensor(u), n)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(batch["obs"].numpy(),
                                  np.asarray(jbatch["obs"]))


@pytest.mark.parametrize("kind", ["uniform", "fused", "legacy"])
def test_empty_buffer_draws_slot_zero(kind):
    gen = torch.Generator().manual_seed(0)
    buf = UniformReplay(32) if kind == "uniform" else \
        PrioritizedReplay(32, fused=kind == "fused")
    out = buf.sample(buf.init(_t(_example())), gen, 8)
    assert (out[1] == 0).all()
    assert (out[0]["obs"] == 0).all()
    if kind != "uniform":
        assert torch.isfinite(out[2]).all()


def test_noise_shapes_and_range():
    gen = torch.Generator().manual_seed(1)
    assert tuple(PrioritizedReplay(20, fused=True).noise(gen, 4).shape) \
        == (20,)
    assert tuple(PrioritizedReplay(20).noise(gen, 4).shape) == (4, 20)
    u = UniformReplay(20).noise(gen, 4)
    assert tuple(u.shape) == (4,) and bool(((u >= 0) & (u < 1)).all())
    g = gumbel_noise(gen, (100000,))
    assert torch.isfinite(g).all()
    assert float(g.mean()) == pytest.approx(0.5772, abs=0.02)  # Euler's γ
