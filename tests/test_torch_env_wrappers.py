"""The port's env wrappers (repro_torch.envs.wrappers) against the JAX
package's on the CPU: every wrapper and the stack of
tests/test_env_api.py on cartpole, pendulum and gridworld, and the two
registered wrapped families (`pendulum-norm`, `cartpole-repeat`).

From the same batched state and action, the port's `step` gives the
state, observation, reward and done of `jax.vmap` of the reference's
step; `step_autoreset` gives the same pre-reset obs, reward and done,
the same merged state on the rows that did not end, ObsNormalize's
statistics on every row (they survive the reset) and a fresh TimeLimit
counter on the rows that did. States are driven a few autoreset steps by
the reference first, so ObsNormalize's counts differ from 1 and some
envs are mid-episode.

Floats are held to f32 atol = rtol = 2e-5 (the same expressions, other
libraries' sin/cos); integers, booleans and specs are exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.envs as jenvs
import repro_torch.envs as tenvs
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.envs.api import tree_map

TOL = dict(atol=2e-5, rtol=2e-5)
N = 12

WRAPPERS = {
    "timelimit": lambda m, e: m.TimeLimit(e, 5),
    "obsnorm": lambda m, e: m.ObsNormalize(e),
    "rewscale": lambda m, e: m.RewardScale(e, 0.5),
    "repeat": lambda m, e: m.ActionRepeat(e, 2),
    "stack": lambda m, e: m.ObsNormalize(m.TimeLimit(m.RewardScale(e, 0.5),
                                                     5)),
}
BASES = ("CartPole", "Pendulum", "GridWorld")
REGISTERED = ("pendulum-norm", "cartpole-repeat")
CASES = [f"{b}:{w}" for b in BASES for w in sorted(WRAPPERS)] + \
    [f"registered:{n}" for n in REGISTERED]


def _pair(case):
    """(JAX env, port env) for a case."""
    kind, name = case.split(":")
    if kind == "registered":
        return jenvs.make(name), tenvs.make(name)
    return (WRAPPERS[name](jenvs, getattr(jenvs, kind)()),
            WRAPPERS[name](tenvs, getattr(tenvs, kind)()))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(tree):
    return tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


def _innermost(state):
    while "inner" in state:
        state = state["inner"]
    return state


def _actions(spec, rng, n):
    if spec.action.discrete:
        return rng.integers(0, spec.action.n, n).astype(np.int32)
    return rng.uniform(-3.0, 3.0, (n,) + spec.action.shape).astype(
        np.float32)


def _driven(jenv, seed, steps=3):
    """A batched reference state after `steps` autoreset steps, with
    every third env one step before its base env's cap."""
    key = jax.random.PRNGKey(seed)
    state = jenv.reset_batch(key, N)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        a = jnp.asarray(_actions(jenv.spec, rng, N))
        state, *_ = jenv.step_autoreset(state, a, jax.random.fold_in(key, i))
    base = jenv
    while hasattr(base, "inner"):
        base = base.inner
    inner = _innermost(state)
    inner["t"] = jnp.where(jnp.arange(N) % 3 == 0,
                           base.spec.episode_len - 1, inner["t"])
    return state, _actions(jenv.spec, rng, N)


def _assert_same(got, want, rows=None):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if rows is not None:
        got, want = got[rows], want[rows]
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


def _space_fields(space):
    dt = space.dtype
    name = (str(dt).split(".")[-1] if isinstance(dt, torch.dtype)
            else np.dtype(jnp.dtype(dt)).name)
    return (tuple(space.shape), name, space.low, space.high, space.n)


@pytest.mark.parametrize("case", CASES)
def test_wrapped_spec_matches_jax(case):
    jenv, tenv = _pair(case)
    ours, theirs = tenv.spec, jenv.spec
    assert (ours.name, ours.episode_len, ours.obs_dim, ours.n_actions,
            ours.act_dim) == (theirs.name, theirs.episode_len,
                              theirs.obs_dim, theirs.n_actions,
                              theirs.act_dim)
    assert _space_fields(ours.observation) == _space_fields(
        theirs.observation)
    assert _space_fields(ours.action) == _space_fields(theirs.action)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_wrapped_step_matches_jax(case, seed):
    jenv, tenv = _pair(case)
    jstate, action = _driven(jenv, seed)
    js, jo, jr, jd = jenv.step_batch(jstate, jnp.asarray(action))
    ts, to, tr, td = tenv.step(_to_torch(_np_tree(jstate)),
                               torch.as_tensor(action))
    tree_map(_assert_same, ts, _np_tree(js))
    for got, want in ((to, jo), (tr, jr), (td, jd)):
        _assert_same(got, want)
    _assert_same(tenv.obs(ts), jax.vmap(jenv.obs)(js))
    _assert_same(tenv.obs(_to_torch(_np_tree(jstate))),
                 jax.vmap(jenv.obs)(jstate))


def _obsnorm_paths(env, path=()):
    """Key paths of the `wrap` dicts that ObsNormalize owns."""
    out = []
    while hasattr(env, "inner"):
        if isinstance(env, tenvs.ObsNormalize):
            out.append(path + ("wrap",))
        env, path = env.inner, path + ("inner",)
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("case", CASES)
def test_wrapped_step_autoreset_matches_jax(case):
    jenv, tenv = _pair(case)
    jstate, action = _driven(jenv, 2)
    key = jax.random.PRNGKey(7)
    jnew, jo, jr, jd = jenv.step_autoreset(jstate, jnp.asarray(action), key)
    tnew, to, tr, td = tenv.step_autoreset(
        _to_torch(_np_tree(jstate)), torch.as_tensor(action),
        torch.Generator().manual_seed(7))
    for got, want in ((to, jo), (tr, jr), (td, jd)):
        _assert_same(got, want)
    done = td.numpy()
    assert done.any() and not done.all()
    tree_map(lambda g, w: _assert_same(g, w, ~done), tnew, _np_tree(jnew))
    # running statistics survive the boundary on every row
    for path in _obsnorm_paths(tenv):
        tree_map(_assert_same, _get(tnew, path), _np_tree(_get(jnew, path)))
    # the merged state steps on, and finished envs begin anew
    inner = _innermost(tnew)
    assert bool(torch.all(inner["t"][td] == 0))
    tenv.step_autoreset(tnew, torch.as_tensor(action), torch.Generator())


def test_timelimit_one_step_boundary_matches_jax():
    """TimeLimit(·, 1): every step ends an episode; the returned obs is
    the reference's terminal obs of the pre-reset state, and the merged
    state is a fresh episode (counter 0, new obs)."""
    jenv = jenvs.TimeLimit(jenvs.CartPole(), 1)
    tenv = tenvs.TimeLimit(tenvs.CartPole(), 1)
    jstate = jenv.reset_batch(jax.random.PRNGKey(0), N)
    action = np.arange(N, dtype=np.int32) % 2
    _, jterm, _, jd = jenv.step_batch(jstate, jnp.asarray(action))
    new, obs, _, done = tenv.step_autoreset(
        _to_torch(_np_tree(jstate)), torch.as_tensor(action),
        torch.Generator().manual_seed(0))
    assert bool(done.all()) and bool(np.all(np.asarray(jd)))
    _assert_same(obs, jterm)
    assert torch.equal(new["wrap"]["t"], torch.zeros(N, dtype=torch.int32))
    assert not torch.allclose(tenv.obs(new), obs)


def test_obsnorm_stats_survive_autoreset_and_timelimit_resets():
    """ObsNormalize over TimeLimit(·, 2): six autoreset steps leave every
    env's count at 7 (the init count of 1 plus six steps) while the
    TimeLimit counter below it restarted at each boundary; the stats
    stay per env (each row its own mean)."""
    env = tenvs.ObsNormalize(tenvs.TimeLimit(tenvs.Pendulum(), 2))
    gen = torch.Generator().manual_seed(0)
    state = env.reset(gen, 4)
    assert state["wrap"]["count"].shape == (4,)
    for _ in range(6):
        a = env.spec.action.sample(gen, 4)
        state, _, _, _ = env.step_autoreset(state, a, gen)
    assert torch.equal(state["wrap"]["count"], torch.full((4,), 7.0))
    assert int(state["inner"]["wrap"]["t"].max()) <= 2
    mean = state["wrap"]["mean"]
    assert mean.shape == (4, 3) and not torch.allclose(mean[0], mean[1])


def test_obsnorm_spec_publishes_clip_bounds():
    env = tenvs.make("pendulum-norm")
    assert (env.spec.observation.low, env.spec.observation.high) == (-10.0,
                                                                      10.0)
    assert tenvs.Pendulum().spec.observation.high == 1.0  # inner untouched
    state = env.reset(torch.Generator().manual_seed(0), 8)
    assert env.spec.observation.contains(env.obs(state))


def test_action_repeat_refuses_zero():
    with pytest.raises(ValueError, match="repeat"):
        tenvs.ActionRepeat(tenvs.CartPole(), 0)


@pytest.mark.parametrize("name,algo", [("pendulum-norm", "ppo"),
                                       ("cartpole-repeat", "impala")])
def test_registered_wrapped_env_trains(name, algo):
    cfg = TrainerConfig(algo=algo, iters=3, superstep=3, n_envs=4,
                        unroll=8, log_every=1,
                        algo_kwargs={"hidden": (8,)})
    state, hist = Trainer(tenvs.make(name), cfg, device="cpu").fit()
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(torch.isfinite(p).all() for p in state.params.values())
