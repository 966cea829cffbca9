"""What tests/test_torch_processes.py runs in each rank's process (spawned
processes import it by name, so it lives beside the tests and imports no
JAX): the collectives of a `ProcessPositions` group, small Trainer fits
over one, and the failures the launcher must report."""
import time

import numpy as np
import torch

import repro_torch.envs as envs
from repro_torch.core.distribution import DistPlan
from repro_torch.core.trainer import Trainer, TrainerConfig, state_to

SMALL = dict(iters=4, superstep=2, n_envs=8, unroll=8, log_every=1, seed=0)
HIDDEN = {"hidden": (8,)}
# each fit: its algorithm and plan; the rest of SMALL unless given
FITS = {
    "impala_flat4": dict(algo="impala", plan="workers=4:allreduce:bsp"),
    "impala_grid_gossip_asp": dict(
        algo="impala", plan="hosts=2:allreduce:bsp,workers=2:gossip:asp"),
    "impala_shard": dict(
        algo="impala",
        plan="workers=2:allreduce:bsp,shard=2:allreduce:bsp:shard"),
    "impala_zero3": dict(
        algo="impala",
        plan="workers=2:allreduce:bsp,shard=2:allreduce:bsp:zero3"),
    "a3c_actors": dict(algo="a3c", plan="workers=4:allreduce:bsp",
                       actors=(16, 32), n_envs=16),
    "dqn_replay": dict(
        algo="dqn",
        plan="workers=2:allreduce:bsp,replay=2:allreduce:bsp:replay",
        algo_kwargs={"hidden": (8,), "warmup": 2, "replay_capacity": 256,
                     "batch_size": 16}),
    "a3c_pipelined_ssp": dict(algo="a3c", plan="workers=2:allreduce:ssp",
                              pipeline=True),
}
# the compile_collectives plans of tests/test_torch_multi_position.py
SPECS = ["workers=4:allreduce:bsp", "workers=4:ps:bsp",
         "workers=4:gossip:bsp",
         "hosts=2:allreduce:bsp,workers=2:allreduce:bsp",
         "hosts=2:ps:bsp,workers=2:allreduce:bsp",
         "hosts=2:gossip:bsp,workers=2:allreduce:bsp",
         "hosts=2:allreduce:bsp,workers=2:gossip:bsp",
         "hosts=2:ps:bsp,workers=2:ps:bsp"]
# the shard groups of workers=2 x shard=2, and each rank's chunks
MEMBERS = [[0, 1], [0, 1], [2, 3], [2, 3]]


def chunks(rank):
    return [torch.arange(3.0) + 10 * rank, torch.arange(2.0) - 10 * rank]


def config(name) -> TrainerConfig:
    f = FITS[name]
    plan = DistPlan.parse(f["plan"], staleness_bound=1,
                          actors=f.get("actors"))
    return TrainerConfig(algo=f["algo"], plan=plan,
                         pipeline=f.get("pipeline", False),
                         algo_kwargs=f.get("algo_kwargs", HIDDEN),
                         **dict(SMALL, n_envs=f.get("n_envs", 8)))


def fit(name, positions=None):
    """(final state on the CPU, history) of fit `name`, one position in
    this process under `positions`, every position in threads without."""
    tr = Trainer(envs.make("cartpole"), config(name), device="cpu",
                 positions=positions)
    state, hist = tr.fit()
    return state_to(state, "cpu"), hist


def grads(shape, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(tuple(shape) + (3, 4)).astype(
                np.float32),
            "b": rng.standard_normal(tuple(shape) + (5,)).astype(
                np.float32)}


def own_grads(spec, rank):
    """Rank `rank`'s tree of the plan's (mesh...) gradients."""
    plan = DistPlan.parse(spec)
    at = np.unravel_index(rank, plan.mesh_shape)
    return {k: torch.tensor(v[at])
            for k, v in grads(plan.mesh_shape, len(spec)).items()}


def hooks(group, spec, rank, tree):
    """{"grad"/"param": rank's tree through the plan's hook} over
    `group` (a `PositionGroup` or `ProcessPositions`)."""
    plan = DistPlan.parse(spec)
    out = {}
    for label, fn in zip(("grad", "param"), plan.compile_collectives()):
        if fn is not None:
            out[label] = group.hook(rank, fn, plan.sim_shape)(tree)
    return out


def rank_main(group, names):
    """In each rank: every collective case (at W = 4), then the fits of
    `names` whose plan has this group's position count."""
    out = {"fits": {}}
    if group.n == 4:
        out["hooks"] = {spec: hooks(group, spec, group.rank,
                                    own_grads(spec, group.rank))
                        for spec in SPECS}
        out["shard_gather"] = group.shard_gather(group.rank, MEMBERS)(
            chunks(group.rank))
        out["metrics"] = group.all_gather(torch.full((2, 3), group.rank
                                                     + 0.5))
    for name in names:
        if config(name).plan.sim_devices == group.n:
            out["fits"][name] = fit(name, group)
    return out


def fail_at(group, rank, it):
    """impala flat(2) over `group`, rank `rank` raising at iteration
    `it`'s learner step (the others then wait in its collective)."""
    if group.rank == rank:
        consume = Trainer._consume

        def failing(self, state, ep_run, ep_last, item, at, r=0):
            if at == it:
                raise RuntimeError(f"injected failure at iteration {at}")
            return consume(self, state, ep_run, ep_last, item, at, r)

        Trainer._consume = failing
    tr = Trainer(envs.make("cartpole"), TrainerConfig(
        algo="impala", plan=DistPlan.flat(2), algo_kwargs=HIDDEN, **SMALL),
        device="cpu", positions=group)
    tr.fit()


def skip_collective(group, rank):
    """Every rank but `rank` meets at one all-gather; `rank` stays away
    (alive) past the group's timeout."""
    if group.rank == rank:
        time.sleep(4 * group.timeout)
        return None
    return group.all_gather(torch.ones(3))


def sleep_for(group, seconds):
    """Every rank sleeps `seconds` (past the launcher's deadline)."""
    time.sleep(seconds)
