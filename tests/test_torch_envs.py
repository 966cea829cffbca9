"""The port's batched envs against the JAX package: equal specs for every
name the port registers; from the same state, action and scenario, the
same next state, observation, reward and done (cartpole, pendulum,
gridworld and their `-rand` families); resets inside the spec and the
scenario ranges; `step_autoreset` returning the pre-reset terminal
observation.

Floats are held to f32 atol = rtol = 2e-5 (the same expressions, other
libraries' sin/cos); integers, booleans and specs are exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as jenvs
import repro_torch.envs as tenvs
from repro_torch.envs.api import tree_map

TOL = dict(atol=2e-5, rtol=2e-5)
NAMES = ["cartpole", "cartpole-rand", "pendulum", "pendulum-rand",
         "gridworld", "gridworld-rand"]
N = 16


def _dtype_name(dt):
    if isinstance(dt, torch.dtype):
        return str(dt).split(".")[-1]
    return np.dtype(jnp.dtype(dt)).name


def _space_fields(space):
    return (tuple(space.shape), _dtype_name(space.dtype), space.low,
            space.high, space.n, space.size, space.midpoint,
            space.half_range, space.discrete)


def test_port_registers_the_base_envs_and_rand_families():
    assert set(NAMES) <= set(tenvs.available())
    assert tenvs.available() == jenvs.available()


@pytest.mark.parametrize("name", NAMES)
def test_specs_equal(name):
    ours, theirs = tenvs.make(name).spec, jenvs.make(name).spec
    assert (ours.name, ours.episode_len, ours.obs_dim, ours.n_actions,
            ours.act_dim) == (theirs.name, theirs.episode_len,
                              theirs.obs_dim, theirs.n_actions,
                              theirs.act_dim)
    assert _space_fields(ours.observation) == _space_fields(
        theirs.observation)
    assert _space_fields(ours.action) == _space_fields(theirs.action)


def _jax_batch(name, seed):
    env = jenvs.make(name)
    state = env.reset_batch(jax.random.PRNGKey(seed), N)
    if name.startswith("cartpole"):  # push some envs near the limits
        state["s"] = state["s"] * jnp.linspace(1.0, 60.0, N)[:, None]
    if name.startswith("pendulum"):
        state["thdot"] = state["thdot"] * 8.0
    state["t"] = state["t"] + jnp.arange(N, dtype=jnp.int32) * 14
    rng = np.random.default_rng(seed)
    spec = env.spec
    if spec.action.discrete:
        action = rng.integers(0, spec.action.n, N).astype(np.int32)
    else:
        action = rng.uniform(-3.0, 3.0, (N,) + spec.action.shape) \
            .astype(np.float32)
    return env, state, action


def _to_torch(tree):
    return tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


def _assert_same(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_step_matches_jax(name, seed):
    jenv, jstate, action = _jax_batch(name, seed)
    tenv = tenvs.make(name)
    js, jo, jr, jd = jenv.step_batch(jstate, jnp.asarray(action))
    ts, to, tr, td = tenv.step(_to_torch(jstate), torch.as_tensor(action))
    tree_map(_assert_same, ts, {k: js[k] for k in ts})
    _assert_same(to, jo)
    _assert_same(tr, jr)
    _assert_same(td, jd)
    _assert_same(tenv.obs(ts), jax.vmap(jenv.obs)(js))
    assert bool(td.any())  # the batch reaches episode ends


@pytest.mark.parametrize("name", NAMES)
def test_reset_lies_in_spec_and_scenario_ranges(name):
    env = tenvs.make(name)
    state = env.reset(torch.Generator().manual_seed(0), 64)
    obs = env.obs(state)
    assert obs.shape == (64,) + env.spec.observation.shape
    assert env.spec.observation.contains(obs)
    assert int(state["t"].abs().sum()) == 0
    jstate = jenvs.make(name).reset_batch(jax.random.PRNGKey(0), 4)
    assert sorted(state) == sorted(jstate)
    assert sorted(state["scn"]) == sorted(jstate["scn"])
    for k, v in state["scn"].items():
        assert _dtype_name(v.dtype) == _dtype_name(jstate["scn"][k].dtype)
        assert v.shape[1:] == jstate["scn"][k].shape[1:]
    ranges = env._ranges
    for k, (lo, hi) in ranges.items():
        v = state["scn"][k].float()
        assert float(v.min()) >= lo and float(v.max()) <= hi, k
        assert float(v.max()) > float(v.min()), k  # really randomized
    if name == "gridworld-rand":
        n = state["scn"]["n"][:, None]
        assert bool(torch.all(state["scn"]["goal"] < n))
        assert bool(torch.all(state["pos"] < n))


def test_scenario_overrides_and_unknown_fields():
    env = tenvs.make("cartpole", scenario={"masspole": 0.3})
    state = env.reset(torch.Generator(), 3)
    assert torch.allclose(state["scn"]["masspole"], torch.tensor(0.3))
    with pytest.raises(KeyError, match="unknown scenario field"):
        tenvs.make("cartpole", scenario={"mass": 1.0})
    with pytest.raises(KeyError, match="unknown scenario range"):
        tenvs.make("pendulum", ranges={"mass": (0, 1)})
    with pytest.raises(KeyError, match="unknown environment"):
        tenvs.make("cartpole-norm")


@pytest.mark.parametrize("name", ["cartpole", "pendulum", "gridworld-rand"])
def test_step_autoreset_returns_pre_reset_terminal_obs(name):
    env = tenvs.make(name)
    gen = torch.Generator().manual_seed(3)
    state = env.reset(gen, 8)
    state["t"] = torch.full_like(state["t"], env.spec.episode_len - 1)
    state["t"][:4] = 0                      # half the batch carries on
    action = env.spec.action.sample(gen, 8)
    stepped, obs_step, r_step, d_step = env.step(state, action)
    new, obs, reward, done = env.step_autoreset(state, action, gen)
    assert torch.equal(done, d_step) and bool(done[4:].all())
    assert torch.equal(obs, obs_step)       # terminal obs, not the reset one
    assert torch.equal(reward, r_step)
    assert bool(torch.all(new["t"][done] == 0))   # fresh episodes
    assert torch.equal(new["t"][~done], stepped["t"][~done])
    assert not torch.equal(env.obs(new)[done], obs[done])
