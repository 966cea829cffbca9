"""One learner step per algorithm with several data positions
(repro_torch.core.{agent,algos} under `grad_tx`/`param_tx`, the positions
meeting in a `PositionGroup`, one thread each) on the CPU, against the
reference's `learner_step` under `jax.vmap(axis_name="workers")` with the
reference's own `compile_collectives` hooks: ppo, a3c, impala and dqn at
W = 2 and ppo at W = 4, for allreduce, ps and gossip. Every position
starts from the same state (a JAX init) and learns on its own trajectory
(a JAX rollout); PPO's permutations and DQN's Gumbel noise come from
JAX's per-position keys. Params, optimizer moments, ring and loss are held
to the tolerances of tests/test_torch_train.py::
test_learner_step_matches_jax; under allreduce and ps every position's
params come out bitwise equal.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as jenvs
from repro.core import agent as jax_agents
from repro.core.distribution import DistPlan as JaxPlan
from repro.core.rollout import rollout_fresh as jax_rollout_fresh
import repro_torch.envs as envs
from repro_torch.checkpoint.convert import (params_from_jax, ring_from_jax,
                                            train_state_from_jax)
from repro_torch.core import agent as agent_api
from repro_torch.core.distribution import DistPlan
from repro_torch.core.positions import PositionGroup

TOL = dict(atol=1e-5, rtol=1e-5)

HIDDEN = (16, 16)
DQN_KW = dict(replay_capacity=64, batch_size=16, warmup=0, target_update=2,
              total_iters=10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _steps(name, W, topo, T=8, B=4, seed=0):
    """Per position: (JAX state after the vmapped learner step, its
    loss) and (the port's, from a PositionGroup)."""
    kw = dict(hidden=HIDDEN, **(DQN_KW if name == "dqn" else {}))
    jenv = jenvs.make("cartpole")
    jag = jax_agents.make(name, env=jenv, ring_size=2, **kw)
    k_init, k_roll, k_learn = jax.random.split(jax.random.PRNGKey(seed), 3)
    jstate = jag.init(k_init)
    rolls = [jax_rollout_fresh(jag.policy, jag.actor_policy(jstate, 0),
                               jenv, k, T, B)
             for k in jax.random.split(k_roll, W)]
    jtraj = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                   *[r[0] for r in rolls])
    jboot = jnp.stack([jax.vmap(jenv.obs)(r[1]) for r in rolls])
    keys = jax.random.split(k_learn, W)
    jgrad, jparam = JaxPlan.flat(W, collective=topo).compile_collectives()
    jnew, jm = jax.jit(jax.vmap(
        lambda tr, bo, k: jag.learner_step(jstate, tr, bo, k,
                                           grad_tx=jgrad, param_tx=jparam),
        axis_name="workers"))(jtraj, jboot, keys)

    tag = agent_api.make(name, env=envs.make("cartpole"), ring_size=2,
                         device="cpu", **kw)
    agents = [tag] + [copy.deepcopy(tag) for _ in range(W - 1)]
    grad_fn, param_fn = DistPlan.flat(W, collective=topo).compile_collectives()
    group = PositionGroup(W, timeout=60.0)

    def work(r):
        hooks = {"grad_tx": grad_fn and group.hook(r, grad_fn, (W,)),
                 "param_tx": param_fn and group.hook(r, param_fn, (W,))}
        state = train_state_from_jax(_np(jstate))
        traj = {k: torch.tensor(np.asarray(v[r])) for k, v in jtraj.items()}
        boot = torch.tensor(np.asarray(jboot[r]))
        ag = agents[r]
        if name == "ppo":
            perms = np.stack([np.asarray(jax.random.permutation(k, T * B))
                              for k in jax.random.split(keys[r],
                                                        ag.n_epochs)])
            return ag.learner_step_perms(state, traj, boot,
                                         torch.tensor(perms), **hooks)
        if name == "dqn":
            noise = jax.random.gumbel(keys[r], (DQN_KW["replay_capacity"],))
            return ag.learner_step_noise(state, traj, boot,
                                         torch.tensor(np.asarray(noise)),
                                         **hooks)
        return ag.learner_step(state, traj, boot, None, **hooks)

    try:
        port = group.run(work)
    finally:
        group.close()
    return jnew, np.asarray(jm["loss"]), port


@pytest.mark.parametrize("name,W", [("ppo", 2), ("a3c", 2), ("impala", 2),
                                    ("dqn", 2), ("ppo", 4)])
@pytest.mark.parametrize("topo", ["allreduce", "ps", "gossip"])
def test_learner_step_under_collectives_matches_jax(name, W, topo):
    jnew, jloss, port = _steps(name, W, topo)
    for r, (tnew, tm) in enumerate(port):
        jr = jax.tree_util.tree_map(lambda a: np.asarray(a[r]), jnew)
        assert float(tm["loss"]) == pytest.approx(float(jloss[r]), abs=1e-5,
                                                  rel=1e-5)
        want = params_from_jax(jr.params)
        assert set(want) == set(tnew.params)
        for k, v in want.items():
            np.testing.assert_allclose(tnew.params[k].numpy(), v.numpy(),
                                       **TOL, err_msg=f"rank {r} {k}")
        for moment in ("m", "v"):
            for k, v in params_from_jax(jr.opt_state[moment]).items():
                np.testing.assert_allclose(
                    tnew.opt_state[moment][k].numpy(), v.numpy(), **TOL,
                    err_msg=f"rank {r} {moment} {k}")
        for k, v in ring_from_jax(jr.ring).items():
            np.testing.assert_allclose(tnew.ring[k].numpy(), v.numpy(),
                                       **TOL, err_msg=f"rank {r} ring {k}")
    if topo != "gossip":   # one exchanged gradient: replicas stay equal
        for tnew, _ in port[1:]:
            for k, v in port[0][0].params.items():
                assert torch.equal(tnew.params[k], v)
