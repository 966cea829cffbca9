"""The port's evolution methods (repro_torch.core.evo) and its fitness,
`rollout.episode_return`, against the JAX package on the CPU:

  (a) `centered_ranks` exactly the reference's (ties included), `top_k` in
      jax.lax.top_k's order, and the flat parameter layout in
      `ravel_pytree`'s order;
  (b) `episode_return` per member of a population batch against the
      reference's per-member episodes from the same start states (greedy
      cartpole exact, mean-action pendulum within atol 1e-3 over 50
      steps of f32 dynamics), and the action box read off the spec;
  (c) one ES, DeepGA and ERL step against the reference's step with the
      reference's draws passed in (ES: ε and the common start; GA: the
      generation's fitnesses, parent choices and seeds; ERL: starts,
      sampling noise, parents, mutation and replay draws): θ within
      atol = rtol = 1e-5, GA chains exact, ERL's population, learner,
      optimizer state and replay within 1e-4 (f32 sums over a 30-step
      episode and 2 learner updates in another order); comm_bytes equal;
  (d) the ideas of tests/test_evo.py as torch twins: the ES gradient
      estimator's direction, GA seed-chain reconstruction bitwise, ES and
      GA learning sanity, ERL injection runs.
"""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as jenvs
import repro_torch.envs as tenvs
from repro.core.evo import ERL as JaxERL
from repro.core.evo import ES as JaxES
from repro.core.evo import DeepGA as JaxGA
from repro.core.evo.es import centered_ranks as jax_centered_ranks
from repro.core.networks import MLPPolicy as JaxMLP
from repro.core.rollout import episode_return as jax_episode_return
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.core.evo import ERL, ES, DeepGA, centered_ranks
from repro_torch.core.evo.es import FlatLayout, common_start, top_k
from repro_torch.core.networks import MLPPolicy
from repro_torch.core.rollout import episode_return
from repro_torch.envs.api import tree_map
from repro_torch.envs.spec import EnvSpec, box
from repro_torch.optim import adamw

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(tree):
    """A JAX tree (dicts) -> the port's (torch leaves)."""
    return tree_map(lambda a: torch.as_tensor(np.array(a)),
                    jax.tree_util.tree_map(np.asarray, tree))


def _params(p):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, p))


def _pair(env_name, hidden=(8,)):
    jenv, tenv = jenvs.make(env_name), tenvs.make(env_name)
    return (jenv, tenv, JaxMLP.for_spec(jenv.spec, hidden=hidden),
            MLPPolicy.for_spec(tenv.spec, hidden=hidden, device="cpu"))


def _batch(states):
    """Stack a list of single reference env states into a port batch."""
    return _t(jax.tree_util.tree_map(lambda *a: jnp.stack(a), *states))


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("seed,n", [(0, 4), (1, 17), (2, 64)])
def test_centered_ranks_exact(seed, n):
    rng = np.random.default_rng(seed)
    for x in (rng.standard_normal(n).astype(np.float32),
              rng.integers(0, 4, n).astype(np.float32)):     # ties
        got = centered_ranks(torch.tensor(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jax_centered_ranks(jnp.asarray(x))))
        assert abs(got.sum()) < 1e-4 and got.max() == 0.5


def test_top_k_takes_lax_top_k_order():
    x = np.array([3, 7, 7, 1, 7, 3, 0, 7], np.float32)
    for k in (1, 3, 5):
        _, want = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(top_k(torch.tensor(x), k).numpy(),
                                      np.asarray(want))


def test_flat_layout_is_ravel_pytree_order():
    _, _, jpol, _ = _pair("pendulum", hidden=(8, 4))
    jp = jpol.init(jax.random.PRNGKey(0))
    flat, _ = jax.flatten_util.ravel_pytree(jp)
    params = _params(jp)
    layout = FlatLayout.of(params)
    theta = layout.ravel(params)
    np.testing.assert_array_equal(theta.numpy(), np.asarray(flat))
    back = layout.unravel(torch.stack([theta, 2 * theta]))
    for k, v in params.items():
        assert torch.equal(back[k][0], v) and torch.equal(back[k][1], 2 * v)


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("env_name,atol", [("cartpole", 0.0),
                                           ("pendulum", 1e-3)])
def test_episode_return_per_member_matches_jax(env_name, atol):
    jenv, tenv, jpol, tpol = _pair(env_name)
    P, steps = 6, 50
    keys = jax.random.split(jax.random.PRNGKey(3), P)
    jps = [jpol.init(jax.random.fold_in(keys[m], 1)) for m in range(P)]
    want = [float(jax_episode_return(jpol, jps[m], jenv, keys[m], steps))
            for m in range(P)]
    params = {k: torch.stack([_params(p)[k] for p in jps])
              for k in _params(jps[0])}
    start = _batch([jenv.reset(k) for k in keys])
    got = episode_return(tpol, params, tenv, max_steps=steps, state=start)
    assert got.shape == (P,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


class _BoundsProbe:
    """A batched probe env: reward = the action, 4 steps, on a ±0.5 box."""
    spec = EnvSpec("probe", observation=box((1,)),
                   action=box((1,), low=-0.5, high=0.5), episode_len=4)

    def reset(self, generator, n):
        return {"t": torch.zeros((n,), dtype=torch.int32)}

    def obs(self, state):
        return torch.zeros((state["t"].shape[0], 1))

    def step(self, state, action):
        t = state["t"] + 1
        return {"t": t}, self.obs(state), action.reshape(-1), t >= 4


def test_episode_return_reads_action_bounds_from_spec():
    env = _BoundsProbe()
    pol = MLPPolicy.for_spec(env.spec, hidden=(4,), device="cpu")
    p = pol.init(torch.Generator().manual_seed(0))
    p["pi/b"] = torch.full_like(p["pi/b"], 10.0)    # saturate
    params = {k: v[None].expand((2,) + v.shape) for k, v in p.items()}
    total = episode_return(pol, params, env, torch.Generator(), 6)
    np.testing.assert_allclose(total.numpy(), [2.0, 2.0], atol=1e-2)


# ------------------------------------------------------------------ (c)
def test_es_step_matches_jax():
    jenv, tenv, jpol, tpol = _pair("pendulum")
    kw = dict(pop_size=8, sigma=0.2, lr=0.1, max_steps=30)
    jes, tes = JaxES(jpol, jenv, **kw), ES(tpol, tenv, **kw)
    jtheta = jes.init(jax.random.PRNGKey(1))
    tes.init(torch.Generator())                    # sets the layout
    theta = torch.tensor(np.asarray(jtheta))
    key = jax.random.PRNGKey(2)
    jnew, jfit, jcomm = jes.step(jtheta, key)
    k_eps, k_ev = jax.random.split(key)
    eps = jax.random.normal(k_eps, (4, jtheta.shape[0]))
    start = tree_map(lambda a: a.expand((8,) + a.shape[1:]).clone(),
                     _batch([jenv.reset(k_ev)]))
    new, fit, comm = tes.step_noise(theta, torch.tensor(np.asarray(eps)),
                                    start)
    assert comm == jcomm == 4 * 8
    assert float(fit) == pytest.approx(float(jfit), abs=1e-4, rel=1e-5)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), **TOL)


def test_ga_step_matches_jax_with_its_draws():
    jenv, tenv, jpol, tpol = _pair("cartpole")
    kw = dict(pop_size=8, truncation=3, sigma=0.3, max_steps=40,
              chain_len=4)
    jga, tga = JaxGA(jpol, jenv, **kw), DeepGA(tpol, tenv, **kw)
    js = jga.init(jax.random.PRNGKey(0))
    tga.init(torch.Generator())
    for g in range(3):   # chains of several lengths, some full
        js, _, _ = jga.step(js, jax.random.PRNGKey(10 + g))
    key = jax.random.PRNGKey(20)
    jnew, jbest, jcomm = jga.step(js, key)
    k_ev, k_sel, k_mut = jax.random.split(key, 3)
    fits = jax.vmap(jga.fitness)(js["chains"], js["lens"],
                                 jax.random.split(k_ev, 8))
    slots = jax.random.choice(k_sel, 3, (8,))
    _, top = jax.lax.top_k(fits, 3)
    np.testing.assert_array_equal(np.asarray(top[slots]), np.asarray(
        jax.random.choice(k_sel, top, (8,))))
    seeds = jax.random.randint(k_mut, (8,), 1, jnp.iinfo(jnp.int32).max)
    state = {k: torch.tensor(np.asarray(v).astype(np.int64))
             for k, v in js.items()}
    new, best, comm = tga.step_noise(
        state, torch.tensor(np.asarray(fits)),
        torch.tensor(np.asarray(slots)), torch.tensor(np.asarray(seeds)))
    assert comm == jcomm == 8 * 8 and float(best) == float(jbest)
    for k in ("chains", "lens"):
        np.testing.assert_array_equal(new[k].numpy(),
                                      np.asarray(jnew[k]).astype(np.int64))


def test_erl_step_matches_jax_with_its_draws():
    jenv, tenv, jpol, tpol = _pair("pendulum")
    kw = dict(pop_size=4, elite=2, max_steps=30, inject_every=1,
              replay_capacity=256)
    jerl, terl = JaxERL(jpol, jenv, **kw), ERL(tpol, tenv, **kw)
    jstate, jreplay = jerl.init(jax.random.PRNGKey(0))
    _, treplay = terl.init(torch.Generator())      # sets the layout
    jopt, topt = jax_adamw(1e-3), adamw(1e-3)
    jost = jopt.init(jpol.init(jax.random.PRNGKey(1)))
    ost = {"step": torch.tensor(np.asarray(jost["step"])),
           "m": _params(jost["m"]), "v": _params(jost["v"])}
    state = {"pop": torch.tensor(np.asarray(jstate["pop"])),
             "learner": torch.tensor(np.asarray(jstate["learner"])),
             "replay": _t(jstate["replay"]), "gen": 0}
    key = jax.random.PRNGKey(5)
    jnew, jost2, jfits = jerl.step(jstate, jreplay, key, jopt, jost,
                                   learner_updates=2, batch_size=16)
    # the reference's draws, as its step takes them from `key`
    k1, k2, k3, k4 = jax.random.split(key, 4)
    mkeys = jax.random.split(k1, 4)
    start = _batch([jenv.reset(k) for k in mkeys])
    noise = np.stack([[np.asarray(jax.random.normal(kk, (1,)))
                       for kk in jax.random.split(k, 30)] for k in mkeys])
    slots = jax.random.choice(k2, 2, (4,))
    mutation = jax.random.normal(k3, jstate["pop"].shape)
    size = min(4 * 30, 256)
    u = np.stack([(np.asarray(jax.random.randint(
        jax.random.fold_in(k4, i), (16,), 0, size)) + 0.5) / size
        for i in range(2)]).astype(np.float32)
    new, ost2, fits = terl.step_noise(
        state, treplay, topt, ost, start, torch.tensor(noise),
        torch.tensor(np.asarray(slots)), torch.tensor(np.asarray(mutation)),
        torch.tensor(u))
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(fits.numpy(), np.asarray(jfits), **tol)
    for k in ("pop", "learner"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                   **tol)
    assert new["gen"] == jnew["gen"] == 1
    for k, v in jnew["replay"]["store"].items():
        np.testing.assert_allclose(new["replay"]["store"][k].numpy(),
                                   np.asarray(v), **tol)
    assert int(new["replay"]["size"]) == int(jnew["replay"]["size"])
    for moment in ("m", "v"):
        want = _params(jost2[moment])
        for k, v in want.items():
            np.testing.assert_allclose(ost2[moment][k].numpy(), v.numpy(),
                                       **tol)


# ------------------------------------------------------------------ (d)
def test_es_gradient_estimator_unbiased_direction():
    """On f(θ) = -|θ - θ*|², the (unshaped) antithetic ES estimate aligns
    with the analytic gradient (survey §7.1, Eq. 2)."""
    gen = torch.Generator().manual_seed(0)
    theta_star = torch.tensor([1.0, -2.0, 0.5, 3.0])
    theta, sigma, n = torch.zeros(4), 0.1, 4096
    eps = torch.randn((n // 2, 4), generator=gen)
    eps = torch.cat([eps, -eps])
    fits = -((theta[None] + sigma * eps - theta_star) ** 2).sum(-1)
    grad_es = (fits[:, None] * eps).mean(0) / sigma
    grad_true = -2 * (theta - theta_star)
    cos = torch.dot(grad_es, grad_true) / (grad_es.norm() * grad_true.norm())
    assert float(cos) > 0.95


class _PointMass:
    """A smooth batched continuous-control env (the reference test's)."""
    spec = EnvSpec("point-mass", observation=box((2,)),
                   action=box((2,), low=-2.0, high=2.0), episode_len=30)

    def reset(self, generator, n):
        return {"p": torch.randn((n, 2), generator=generator),
                "t": torch.zeros((n,), dtype=torch.int32)}

    def obs(self, s):
        return s["p"]

    def step(self, s, a):
        p = s["p"] + 0.1 * torch.clamp(a.reshape(-1, 2), -2, 2)
        t = s["t"] + 1
        return {"p": p, "t": t}, p, -(p ** 2).sum(-1), t >= 30


def test_es_improves_point_mass():
    env = _PointMass()
    pol = MLPPolicy.for_spec(env.spec, hidden=(8,), device="cpu")
    es = ES(pol, env, pop_size=32, sigma=0.2, lr=0.1, max_steps=30)
    theta = es.init(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    fs = []
    for _ in range(15):
        theta, f, comm = es.step(theta, gen)
        fs.append(float(f))
    assert min(fs[-3:]) > fs[0], fs
    assert comm == 4 * 32


def test_ga_seed_chain_reconstruction_bitwise():
    env = tenvs.CartPole()
    pol = MLPPolicy(env.obs_dim, env.n_actions, hidden=(8,), device="cpu")
    ga = DeepGA(pol, env, pop_size=4, chain_len=8)
    ga.init(torch.Generator().manual_seed(0))
    chain = torch.tensor([[5, 17, 3, 0, 0, 0, 0, 0]])
    t1 = ga.reconstruct(chain, torch.tensor([3]))
    t2 = ga.reconstruct(chain.clone(), torch.tensor([3]))
    assert torch.equal(t1, t2)
    longer = chain.clone()
    longer[0, 3] = 99
    assert not torch.allclose(t1, ga.reconstruct(longer, torch.tensor([4])))
    # slots past the length do not count
    assert torch.equal(t1, ga.reconstruct(longer, torch.tensor([3])))


def test_ga_improves_cartpole():
    env = tenvs.CartPole()
    pol = MLPPolicy(env.obs_dim, env.n_actions, hidden=(8,), device="cpu")
    ga = DeepGA(pol, env, pop_size=24, truncation=6, sigma=0.3,
                max_steps=100)
    state = ga.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    best = []
    for _ in range(8):
        state, bf, comm = ga.step(state, gen)
        best.append(float(bf))
    assert max(best[-3:]) >= best[0], best
    assert comm == 8 * 24


def test_erl_injection_runs():
    env = tenvs.Pendulum()
    pol = MLPPolicy.for_spec(env.spec, hidden=(8,), device="cpu")
    erl = ERL(pol, env, pop_size=4, max_steps=30, inject_every=1)
    gen = torch.Generator().manual_seed(0)
    state, replay = erl.init(gen)
    opt = adamw(1e-3)
    ostate = opt.init(pol.init(gen))
    for _ in range(2):
        state, ostate, fits = erl.step(state, replay, gen, opt, ostate,
                                       learner_updates=2)
    assert bool(torch.isfinite(fits).all())
    assert bool(torch.isfinite(state["pop"]).all())
    # injection: the learner is a member of the population
    assert bool((state["pop"] == state["learner"]).all(-1).any())
    assert int(state["replay"]["size"]) == 2 * 4 * 30
