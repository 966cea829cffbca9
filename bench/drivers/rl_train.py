"""The RL-training driver: `Trainer.fit`, the fused superstep, on the
cell's algorithm, env and policy trunk.

Set-up builds one Trainer with the benchmark's weights (made on the card
from the seed) and calls `fit()` once; everything after is that one fit:

  * superstep 0 is set-up: it warms every shape the window uses, and the
    output check records its first three trajectories and its learner's
    first three optimizer steps (each step's loss as the loss function
    returns it, the optimizer's state after the first step, the weights
    after the third);
  * the window opens at the sync that ends superstep 0 and closes at the
    first superstep sync `--seconds` later; `env_steps_per_s` is every env
    step of the window's supersteps over the window's whole time;
  * with `--trace 1`, two iterations after the window are traced;
  * then the fit is stopped at a superstep boundary, the peak memory is
    read and the reference follows the recorded iterations.

The fit's own superstep loop, its sync and its timing run unchanged: the
driver only watches `Trainer.superstep_s`, which the fit appends to right
after each superstep's one host sync.
"""
from __future__ import annotations

import time

import torch

from bench import counting, harness, weights
from bench.refs import rl as ref
from bench.refs.transformer import rel_gap, set_plain_precision, with_head_dim
from bench.trace import Spans, Window

CHECKED = 3          # the trajectories and optimizer steps checked
TRACED = 2           # the iterations a traced window holds
MAX_ITERS = 100_000  # the fit's length; it is stopped long before


class _Stop(Exception):
    """Ends the fit at a superstep boundary or after a traced window."""


class _OptWatch:
    """The agent's optimizer, telling the driver of each step it applies."""

    def __init__(self, opt, watch):
        self._opt, self._watch = opt, watch

    def __getattr__(self, name):
        return getattr(self._opt, name)

    def apply(self, params, state, grads):
        params, state = self._opt.apply(params, state, grads)
        self._watch.stepped(params, state)
        return params, state


class _Clock(list):
    """`Trainer.superstep_s`: tells the driver of each superstep's end."""

    def __init__(self, watch, items=()):
        super().__init__(items)
        self._watch = watch

    def append(self, seconds):
        super().append(seconds)
        self._watch.superstep_done(len(self))


def program_config(config):
    """The configuration file as the program's ModelConfig."""
    from repro_torch.configs.base import ModelConfig, MoESpec
    fields = {k: config[k] for k in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab", "norm", "rope_theta", "head_dim")}
    fields["layer_pattern"] = tuple(config["layer_pattern"])
    if config.get("moe"):
        fields["moe"] = MoESpec(**config["moe"])
    return ModelConfig(**fields)


class Run:
    """One fit of the cell, watched superstep by superstep."""

    def __init__(self, cell, seed, seconds, trace, device, t_start,
                 stop_after=None):
        from repro_torch import envs
        from repro_torch.core.trainer import Trainer, TrainerConfig

        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.t_start = trace, t_start
        self.stop_after = stop_after        # stop once this many are recorded
        t = cell.traffic
        self.algo, self.hp = t["algo"], t["hp"]
        self.rcfg = with_head_dim(cell.config)
        mcfg = program_config(cell.config)
        tcfg = TrainerConfig(
            algo=t["algo"], iters=MAX_ITERS, superstep=t["superstep"],
            n_envs=t["n_envs"], unroll=t["unroll"], seed=seed,
            algo_kwargs=dict(policy="trunk", trunk_kwargs={
                "arch": mcfg, "reduced": False,
                "use_kernels": cell.config["use_kernels"]}, **t["hp"]))
        watch = self

        class WatchedTrainer(Trainer):
            @property
            def superstep_s(self):
                return self._bench_clock

            @superstep_s.setter
            def superstep_s(self, items):
                self._bench_clock = _Clock(watch, items)

            def _produce(self, state, env_state, it, delay=None, rank=0):
                item, env_state = super()._produce(state, env_state, it,
                                                   delay, rank)
                watch.produced(it, item)
                return item, env_state

            def _consume(self, state, ep_run, ep_last, item, it, rank=0):
                out = super()._consume(state, ep_run, ep_last, item, it, rank)
                watch.consumed(it, out[0], out[3])
                return out

        self.trainer = WatchedTrainer(envs.make(t["env"]), tcfg,
                                      device=device)
        agent = self.trainer.agent
        agent.opt = _OptWatch(agent.opt, self)
        loss_fn = agent.algo.loss

        def watched_loss(*args, **kwargs):
            loss = loss_fn(*args, **kwargs)
            if len(self.losses) < CHECKED:
                self.losses.append(loss.detach().clone())
            return loss

        # the loss is a method of a frozen dataclass: set past its guard
        object.__setattr__(agent.algo, "loss", watched_loss)
        policy = agent.policy
        self.params0 = weights.draw(weights.program_shapes(policy), seed,
                                    self.trainer.device)
        policy.init = lambda generator: {k: v.clone()
                                         for k, v in self.params0.items()}
        self.n_actions = policy.n_actions
        self.positions = policy.obs_dim
        self.trajs, self.losses = [], []
        self.steps = 0
        self.m1 = self.params3 = None
        self.phase = "setup"
        self.setup_s = self.window_s = None
        self.window_supersteps = 0
        self.spans = Spans()
        self.tracer = None
        self.traced_iters = 0
        self.reading = None
        self.trace_tries = 0

    # ---- the watch ---------------------------------------------------
    def produced(self, it, item):
        if it < CHECKED:
            self.trajs.append(({k: v.clone() for k, v in item["traj"].items()},
                               item["boot"].clone()))

    def stepped(self, params, state):
        self.steps += 1
        if self.steps == 1:
            self.m1 = {k: v.clone() for k, v in state["m"].items()}
        if self.steps == CHECKED:
            self.params3 = {k: v.clone() for k, v in params.items()}

    def consumed(self, it, state, metrics):
        if it == CHECKED - 1 and self.stop_after:
            raise _Stop
        if self.tracer is not None:
            self.traced_iters += 1
            if self.traced_iters == TRACED:
                self.reading = self.tracer.stop()
                self.tracer = None
                if self.reading is not None:
                    raise _Stop

    def superstep_done(self, n):
        now = time.perf_counter()
        if self.phase == "setup":
            self.setup_s = now - self.t_start
            self.t0 = now
            self.phase = "window"
        elif self.phase == "window" and now - self.t0 >= self.seconds:
            self.window_s = now - self.t0
            self.window_supersteps = n - 1
            self.peak = torch.cuda.max_memory_allocated() \
                if self.trainer.device.type == "cuda" else 0
            if not self.trace:
                raise _Stop
            self.phase = "trace"
        if self.phase == "trace" and self.tracer is None:
            if self.trace_tries == 5:
                raise _Stop
            self.trace_tries += 1
            self.traced_iters = 0
            self.tracer = Window(self.spans)
            self.tracer.start()

    def fit(self):
        try:
            self.trainer.fit()
        except _Stop:
            pass
        else:
            raise RuntimeError("Trainer.fit returned before the window "
                               "closed: the driver no longer sees its "
                               "supersteps")

    # ---- what the window did -----------------------------------------
    def iteration_flops(self):
        """Model FLOPs of one iteration: the rollout's forwards, the
        learner's forwards and backwards (3 x), the bootstrap forward."""
        t = self.cell.traffic
        n = t["n_envs"] * t["unroll"]
        fwd = lambda samples: counting.trunk_forward_flops(
            self.rcfg, samples, self.positions, self.n_actions)
        if self.algo == "ppo":
            learner = 3 * self.hp["n_epochs"] * fwd(n)
        else:
            learner = 3 * fwd(n)
        return fwd(n) + learner + fwd(t["n_envs"])

    def env_steps(self):
        t = self.cell.traffic
        return (self.window_supersteps * t["superstep"] * t["n_envs"]
                * t["unroll"])


def learner_gaps(got, want, params0):
    """Loss, first-gradient and weight-change gaps of one learner record
    ({"loss": [per step], "m": first moment after the first step,
    "params": after the last}) against the reference's, over the leaves
    the reference moves."""
    moving = ref.moving_leaves(want["m"])
    change = lambda p: {k: p[k] - params0[k] for k in moving}
    return {
        "loss_gap": max(rel_gap(a, b)
                        for a, b in zip(got["loss"], want["loss"])),
        "grad_gap": ref.worst_leaf_gap(got["m"], want["m"], moving),
        "change_gap": ref.worst_leaf_gap(change(got["params"]),
                                         change(want["params"]), moving)}


def check(run):
    """The output check's numbers: the program's records against the
    float32 reference following the same trajectories -> (numbers, the
    reference's record)."""
    set_plain_precision()
    want = ref.follow(run.algo, run.params0, run.trajs, run.rcfg, run.hp,
                      run.seed, CHECKED)
    got = {"loss": [float(x) for x in run.losses], "m": run.m1,
           "params": run.params3}
    traj = run.trajs[0][0]
    return dict(learner_gaps(got, want, run.params0),
                policy_gap=ref.policy_gap(run.params0, traj, traj["logp"],
                                          traj["value"], run.rcfg),
                env_gap=ref.env_gap(run.trajs)), want


def run(cell, seed, seconds, trace, device, t_start):
    if device == "cuda":
        set_plain_precision()
    r = Run(cell, seed, seconds, trace, device, t_start)
    metrics = cell.metrics() if trace else []
    states = harness.install_spans(r.spans, metrics)
    with r.spans:
        r.fit()
    if len(r.trajs) < CHECKED or r.params3 is None \
            or len(r.losses) < CHECKED:
        raise RuntimeError("the fit stopped before the checked iterations")
    attempted = r.window_supersteps * cell.traffic["superstep"]
    info = {"iteration_flops": r.iteration_flops(), "window_s": r.window_s,
            "window_iters": attempted, "traced_iters": TRACED}
    peak = r.peak
    r.trainer = None
    if device == "cuda":
        torch.cuda.empty_cache()
    nums, _ = check(r)
    checks, ok = harness.checks(nums, cell.limits)
    out = {"correct": ok, "attempted": attempted, "failed": 0}
    if trace:
        reading = r.reading
        out["metrics"] = ({} if reading is None else
                          harness.read_metrics(metrics, reading, info,
                                               states))
    else:
        out["metrics"] = {
            "env_steps_per_s": {"value": r.env_steps() / r.window_s,
                                "unit": "env-steps/s"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": r.setup_s, "unit": "s"}}
    out["device"] = (harness.device_info(cell.chips, peak)
                     if device == "cuda" else
                     {"platform": "cpu", "count": 0, "memory_peak_bytes": 0})
    if trace and r.reading is not None:
        out["device"]["busy_s"] = r.reading.busy_s
        out["device"]["window_s"] = r.reading.window_s
        out["breakdown"] = r.reading.breakdown()
    out["checks"] = checks
    return out
