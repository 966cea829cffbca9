"""The sync harness and the stacked distributed step (repro_torch.core.
{sync,topology}, A3C.hogwild_update) on the CPU, against the JAX package
on the same inputs:

  (a) `train_with_staleness` against the reference's on identical
      batches and delay schedules (bsp, ssp, asp), params and losses
      within 1e-5; BSP equals plain SGD on the worker-mean gradient, and
      BSP <= SSP <= ASP in final loss at an aggressive rate (the
      reference's tests/test_sync_topology.py cases);
  (b) `sync_cost_model` against the reference's given the same normal
      draws, within 1e-5, and the ordering BSP >= SSP >= ASP under any
      positive straggler variance;
  (c) `A3C.hogwild_update` against the reference's on the same stale
      copies and trajectories, within 1e-5;
  (d) `make_distributed_step` over 8 workers: every topology converges,
      allreduce and ps keep the replicas bitwise equal, gossip keeps them
      ε-close but not equal (tests/test_sync_topology.py's
      multi-device cases).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as jenvs
from repro.core import agent as jax_agents
from repro.core import sync as jax_sync
from repro.core.rollout import rollout_fresh as jax_rollout_fresh
from repro.optim import sgd as jax_sgd
import repro_torch.envs as envs
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.core import agent as agent_api
from repro_torch.core import sync
from repro_torch.core.positions import Mesh
from repro_torch.core.topology import make_distributed_step, replicate_for
from repro_torch.optim import adamw, sgd

TOL = dict(atol=1e-5, rtol=1e-5)


def _quad(T=30, W=4, seed=0):
    """The reference's quadratic problem, as numpy."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                     (T, W, 16, 3)))
    y = np.einsum("twbd,d->twb", x, np.array([1.0, -2.0, 0.5], np.float32))
    return {"x": x, "y": y.astype(np.float32)}


def _jloss(p, b):
    return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def _tloss(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def _tt(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


# ---------------------------------------------------- (a) the harness
@pytest.mark.parametrize("mech", ["bsp", "ssp", "asp"])
def test_train_with_staleness_matches_jax(mech):
    batches = _quad()
    cfg = jax_sync.SyncConfig(mech, 4, max_delay=3, staleness_bound=1)
    d = jax_sync.make_delays(cfg, 30, jax.random.PRNGKey(7))
    jp, jl = jax_sync.train_with_staleness(
        _jloss, {"w": jnp.zeros((3,))}, jax_sgd(0.1),
        {k: jnp.asarray(v) for k, v in batches.items()}, d)
    tp, tl = sync.train_with_staleness(
        _tloss, {"w": torch.zeros((3,))}, sgd(0.1), _tt(batches),
        torch.tensor(np.asarray(d)))
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_bsp_equals_plain_sgd():
    from repro_torch.core.agent import value_and_grad
    batches = _tt(_quad())
    d = sync.make_delays(sync.SyncConfig("bsp", 4), 30,
                         torch.Generator().manual_seed(0))
    p_bsp, _ = sync.train_with_staleness(_tloss, {"w": torch.zeros((3,))},
                                         sgd(0.1), batches, d)
    opt = sgd(0.1)
    p = {"w": torch.zeros((3,))}
    st = opt.init(p)
    for t in range(30):
        gs = [value_and_grad(_tloss, p, {k: v[t, w] for k, v in
                                         batches.items()})[1]["w"]
              for w in range(4)]
        p, st = opt.apply(p, st, {"w": torch.stack(gs).mean(0)})
    np.testing.assert_allclose(p_bsp["w"].numpy(), p["w"].numpy(),
                               atol=1e-6)


def test_staleness_ordering():
    batches = _tt(_quad(T=60))
    final = {}
    for mech in ("bsp", "ssp", "asp"):
        cfg = sync.SyncConfig(mech, 4, max_delay=8, staleness_bound=1)
        d = sync.make_delays(cfg, 60, torch.Generator().manual_seed(7))
        _, losses = sync.train_with_staleness(
            _tloss, {"w": torch.zeros((3,))}, sgd(0.35), batches, d)
        final[mech] = float(losses[-10:].mean())
    assert final["bsp"] <= final["ssp"] * 1.5 + 1e-6
    assert final["ssp"] <= final["asp"] + 1e-6, final


# --------------------------------------------------- (b) the cost model
@pytest.mark.parametrize("mech", ["bsp", "ssp", "asp"])
@pytest.mark.parametrize("n_steps,bound", [(100, 4), (96, 4), (37, 3)])
def test_sync_cost_model_matches_jax(mech, n_steps, bound):
    cfg = jax_sync.SyncConfig(mech, 16, max_delay=8, staleness_bound=bound)
    key = jax.random.PRNGKey(n_steps)
    want = float(jax_sync.sync_cost_model(cfg, 1.0, 0.3, n_steps, key))
    draws = torch.tensor(np.asarray(jax.random.normal(key, (n_steps, 16))))
    got = float(sync.sync_cost_model(
        sync.SyncConfig(mech, 16, max_delay=8, staleness_bound=bound),
        1.0, 0.3, n_steps, draws=draws))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("std", [0.01, 0.05, 0.2, 0.5])
def test_sync_cost_model_ordering(std):
    times = {}
    for mech in ("bsp", "ssp", "asp"):
        cfg = sync.SyncConfig(mech, 16, max_delay=8, staleness_bound=4)
        times[mech] = float(sync.sync_cost_model(
            cfg, 1.0, std, 96, torch.Generator().manual_seed(1)))
    assert times["asp"] <= times["ssp"] <= times["bsp"], times


# ------------------------------------------------ (c) hogwild_update
def test_hogwild_update_matches_jax():
    n, T, B = 3, 8, 4
    jenv = jenvs.make("cartpole")
    jag = jax_agents.make("a3c", env=jenv, hidden=(16,))
    keys = jax.random.split(jax.random.PRNGKey(3), 2 * n + 1)
    params = jag.policy.init(keys[0])
    stale = [jag.policy.init(k) for k in keys[1:n + 1]]
    rolls = [jax_rollout_fresh(jag.policy, stale[i], jenv, keys[n + 1 + i],
                               T, B) for i in range(n)]
    stack = lambda xs: jax.tree_util.tree_map(lambda *a: jnp.stack(a), *xs)
    trajs = stack([r[0] for r in rolls])
    boots = jnp.stack([jax.vmap(jenv.obs)(r[1]) for r in rolls])
    jstale = stack(stale)
    opt = jag.opt
    jp, jo = jag.algo.hogwild_update(params, opt.init(params), trajs, boots,
                                     jstale, opt, n)

    tag = agent_api.make("a3c", env=envs.make("cartpole"), hidden=(16,),
                         device="cpu")
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tparams = params_from_jax(np_(params))
    tstale = {k: torch.stack([params_from_jax(np_(s))[k] for s in stale])
              for k in tparams}
    ttrajs = {k: torch.tensor(np.asarray(v)) for k, v in trajs.items()}
    tp, to = tag.algo.hogwild_update(
        tparams, tag.opt.init(tparams), ttrajs,
        torch.tensor(np.asarray(boots)), tstale, tag.opt, n)
    for k, v in params_from_jax(np_(jp)).items():
        np.testing.assert_allclose(tp[k].numpy(), v.numpy(), **TOL,
                                   err_msg=k)
    for k, v in params_from_jax(np_(jo["m"])).items():
        np.testing.assert_allclose(to["m"][k].numpy(), v.numpy(), **TOL,
                                   err_msg=k)
    assert int(to["step"]) == n


# --------------------------------------- (d) the stacked distributed step
@pytest.fixture(scope="module")
def topology_results():
    x = torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                                  (8, 32, 3))))
    y = torch.einsum("wbd,d->wb", x, torch.tensor([1.0, -2.0, 0.5]))
    mesh = Mesh(("workers",), (8,), torch.device("cpu"))
    p0 = {"w": torch.zeros((3,))}
    opt = sgd(0.3)
    out = {}
    for topo in ("allreduce", "ps", "gossip"):
        params = replicate_for(mesh, "workers", p0)
        ostate = replicate_for(mesh, "workers", opt.init(p0))
        step = make_distributed_step(_tloss, opt, topo, mesh)
        spread0 = None
        for i in range(25):
            params, ostate, loss = step(params, ostate, {"x": x, "y": y})
            if i == 3:
                spread0 = float(params["w"].std(0, correction=0).max())
        out[topo] = {"loss": float(loss), "spread_early": spread0,
                     "spread_final": float(params["w"].std(
                         0, correction=0).max()),
                     "params": params["w"]}
    return out


def test_all_topologies_converge(topology_results):
    for topo, res in topology_results.items():
        assert res["loss"] < 1e-3, (topo, res)


def test_sync_topologies_keep_replicas_identical(topology_results):
    for topo in ("allreduce", "ps"):
        w = topology_results[topo]["params"]
        assert all(torch.equal(w[0], w[i]) for i in range(1, 8))


def test_gossip_replicas_eps_close_not_identical(topology_results):
    g = topology_results["gossip"]
    assert g["spread_early"] > 1e-6
    assert g["spread_final"] < 0.05


def test_distributed_step_with_a_stateful_optimizer():
    """adamw's moments ride stacked per worker through the step."""
    mesh = Mesh(("workers",), (2,), torch.device("cpu"))
    opt = adamw(0.1)
    p0 = {"w": torch.zeros((3,))}
    params = replicate_for(mesh, "workers", p0)
    ostate = replicate_for(mesh, "workers", opt.init(p0))
    x = torch.randn((2, 8, 3), generator=torch.Generator().manual_seed(0))
    step = make_distributed_step(_tloss, opt, "allreduce", mesh)
    params, ostate, _ = step(params, ostate, {"x": x, "y": x.sum(-1)})
    assert ostate["m"]["w"].shape == (2, 3)
    assert torch.equal(ostate["step"], torch.tensor([1, 1], dtype=torch.int32))
