"""DQN with (prioritized) replay and a target network — the Gorila/Ape-X
learner (survey §3.1), the port of src/repro/core/algos/dqn.py.

Params are one flat dict named by the reference's key paths:
`online/<i>/w`, `online/<i>/b`, `target/<i>/...` and the update counter
`steps`; the optimizer state and the lag ring hold the online net alone,
keyed `<i>/w` and `<i>/b` as the reference's `_ring_init(params["online"])`
stores it, so a JAX Trainer archive restores into the port.

The learner never reads a tensor on the host: the warmup hold, the target
sync and the priority write-back are `torch.where` selects on device
tensors, so a learner step issues no host sync.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.agent import Agent, TrainState, register, value_and_grad
from repro_torch.core.networks import make_policy, request_uniforms
from repro_torch.core.replay import PrioritizedReplay, UniformReplay
from repro_torch.kernels.common import resolve_device
from repro_torch.models.layers import dense_init
from repro_torch.optim import adamw


def sub(params, prefix):
    """The entries of flat `params` under `prefix/`, with it removed."""
    cut = len(prefix) + 1
    return {k[cut:]: v for k, v in params.items()
            if k.startswith(prefix + "/")}


def prefixed(prefix, params):
    return {f"{prefix}/{k}": v for k, v in params.items()}


def select(cond, new, old):
    """`torch.where(cond, new, old)` over nested dicts of tensors."""
    if isinstance(new, dict):
        return {k: select(cond, new[k], old[k]) for k in new}
    return torch.where(cond, new, old)


@dataclasses.dataclass(frozen=True)
class DQN:
    obs_dim: int
    n_actions: int
    hidden: tuple = (64, 64)
    gamma: float = 0.99
    target_update: int = 100
    double: bool = True
    prioritized: bool = True
    replay_capacity: int = 10000
    fused_sampling: bool = True  # Gumbel-top-k kernel path (replay.py);
    #                              False = the legacy categorical draw
    #                              (WITH replacement)
    use_kernel: bool = True  # the fused draw's CUDA kernel; False runs
    #                          its plain version on the card too
    net: object = None  # a q-net adapter (`init`/`apply` -> (q, _)); None =
    #                     the house ReLU MLP below (e.g. TrunkPolicy)
    device: torch.device = torch.device("cpu")

    @property
    def replay(self):
        return (PrioritizedReplay(self.replay_capacity,
                                  fused=self.fused_sampling,
                                  use_kernel=self.use_kernel)
                if self.prioritized
                else UniformReplay(self.replay_capacity))

    # -- q network -----------------------------------------------------
    def init(self, generator):
        """Fresh params from a CPU generator, on the device."""
        if self.net is not None:
            net = self.net.init(generator)
        else:
            sizes = (self.obs_dim,) + tuple(self.hidden) + (self.n_actions,)
            net = {}
            for i in range(len(sizes) - 1):
                net[f"{i}/w"] = dense_init(generator, (sizes[i],
                                                       sizes[i + 1]))
                net[f"{i}/b"] = torch.zeros((sizes[i + 1],))
            net = {k: v.to(self.device) for k, v in net.items()}
        return {**prefixed("online", net),
                **prefixed("target", {k: v.clone() for k, v in net.items()}),
                "steps": torch.zeros((), dtype=torch.int32,
                                     device=self.device)}

    def q_values(self, net, obs):
        if self.net is not None:
            return self.net.apply(net, obs)[0]
        h = obs
        n_layers = len(net) // 2
        for i in range(n_layers - 1):
            h = torch.relu(h @ net[f"{i}/w"] + net[f"{i}/b"])
        return h @ net[f"{n_layers - 1}/w"] + net[f"{n_layers - 1}/b"]

    # -- learner ---------------------------------------------------------
    def td_errors(self, params, batch):
        online, target = sub(params, "online"), sub(params, "target")
        q = self.q_values(online, batch["obs"])
        qa = q.gather(-1, batch["action"].long()[..., None])[..., 0]
        qn_t = self.q_values(target, batch["next_obs"])
        if self.double:
            qn_o = self.q_values(online, batch["next_obs"])
            a_star = torch.argmax(qn_o, dim=-1)
            q_next = qn_t.gather(-1, a_star[..., None])[..., 0]
        else:
            q_next = qn_t.max(dim=-1).values
        target = batch["reward"] + self.gamma * (
            1.0 - batch["done"].to(torch.float32)) * q_next
        return target.detach() - qa

    def loss(self, params, batch, is_weights=None):
        td = self.td_errors(params, batch)
        w = torch.ones_like(td) if is_weights is None else is_weights
        return torch.mean(w * torch.square(td)), td.detach()

    def update(self, params, opt_state, batch, is_weights, optimizer,
               grad_tx=None, param_tx=None):
        """One TD step on a drawn batch: the online net's gradient
        (exchanged by `grad_tx`), the optimizer, `param_tx` on the new
        online net, the update counter and the target sync. Returns
        (params, opt_state, loss, td)."""
        def loss_online(online):
            return self.loss({**params, **prefixed("online", online)},
                             batch, is_weights)

        (loss, td), grads = value_and_grad(
            loss_online, sub(params, "online"), has_aux=True)
        if grad_tx is not None:
            grads = grad_tx(grads)
        online, opt_state = optimizer.apply(sub(params, "online"),
                                            opt_state, grads)
        if param_tx is not None:
            online = param_tx(online)
        steps = params["steps"] + 1
        sync = steps % self.target_update == 0
        target = {k: torch.where(sync, online[k], t)
                  for k, t in sub(params, "target").items()}
        return {**prefixed("online", online), **prefixed("target", target),
                "steps": steps}, opt_state, loss, td

    def learner_step(self, params, opt_state, replay_state, noise,
                     optimizer, batch_size=64):
        """The reference's learner step on a filled replay, with the
        draw's noise given in place of the key (`replay.noise`: the
        Gumbel vector, or the uniform draw's uniforms): draw, `update`,
        and write the |td| priorities back. Returns (params, opt_state,
        replay_state, loss)."""
        replay = self.replay
        if self.prioritized:
            batch, idx, w = replay.sample_with(replay_state, noise,
                                               batch_size)
        else:
            batch, idx = replay.sample_with(replay_state, noise, batch_size)
            w = None
        params, opt_state, loss, td = self.update(params, opt_state, batch,
                                                  w, optimizer)
        if self.prioritized:
            replay_state = replay.update_priorities(replay_state, idx, td)
        return params, opt_state, replay_state, loss

    def act(self, params, obs, noise, epsilon):
        """ε-greedy over the online net's q, with the draws given in place
        of the key: `noise` is (random actions, uniforms), each shaped as
        the batch; a uniform below `epsilon` takes its random action."""
        rand, u = noise
        greedy = torch.argmax(self.q_values(sub(params, "online"), obs),
                              dim=-1)
        return torch.where(u < epsilon, rand.to(greedy.dtype),
                           greedy).to(torch.int32)


class _QPolicy:
    """A DQN net behind the rollout's policy interface: behavior params
    are `{"net/...": online net, "eps": exploration rate}`, so ε rides
    through `actor_policy` and the rollout stays algorithm-agnostic.

    The ε-greedy draw takes its noise as an (n, 2) tensor of uniforms:
    column 0 decides exploration (u < ε), column 1 picks the random action
    floor(u · n_actions)."""

    discrete = True
    noise_dim = 2

    def __init__(self, dqn: DQN):
        self.dqn = dqn
        self.n_actions = dqn.n_actions
        self.device = dqn.device

    def apply(self, params, obs):
        q = self.dqn.q_values(sub(params, "net"), obs)
        return q, q.max(dim=-1).values

    def sample_noise(self, generator, n) -> torch.Tensor:
        return torch.rand((n, self.noise_dim), generator=generator,
                          device=generator.device)

    def request_noise(self, seed: int, ids) -> np.ndarray:
        """Per-request uniforms (len(ids), 2), a pure function of (seed,
        request id)."""
        return request_uniforms(seed, ids, self.noise_dim).astype(np.float32)

    def sample_value(self, params, obs, noise):
        """ε-greedy action, its log-prob under softmax(q), and max q, from
        ONE q evaluation."""
        q = self.dqn.q_values(sub(params, "net"), obs)
        greedy = torch.argmax(q, dim=-1)
        rand = torch.clamp((noise[..., 1] * self.n_actions).long(),
                           max=self.n_actions - 1)
        a = torch.where(noise[..., 0] < params["eps"], rand, greedy)
        logp = torch.log_softmax(q, -1).gather(-1, a[..., None])[..., 0]
        return a.to(torch.int32), logp, q.max(dim=-1).values


class DQNAgent(Agent):
    """DQN/Ape-X behind the unified protocol: the rollout trajectory is
    flattened into transitions and pushed into an on-device replay
    carried in TrainState.extra; one (prioritized) TD update runs per
    iteration after `warmup` iterations of pure collection."""

    def __init__(self, env, ring_size=1, total_iters=None, lr=1e-3,
                 hidden=(64, 64), prioritized=True, replay_capacity=20000,
                 batch_size=64, warmup=8, eps_start=1.0, eps_end=0.05,
                 eps_decay_steps=None, policy="mlp", trunk_kwargs=None,
                 device="cuda", **algo_kwargs):
        spec = env.spec
        self.device = resolve_device(device)
        self.obs_space = spec.observation
        net = None
        if policy != "mlp":
            net = make_policy(spec, policy, device=self.device,
                              **(trunk_kwargs or {}))
        self.dqn = DQN(spec.obs_dim, spec.n_actions, hidden=tuple(hidden),
                       prioritized=prioritized,
                       replay_capacity=replay_capacity, net=net,
                       device=self.device, **algo_kwargs)
        self.policy = _QPolicy(self.dqn)
        self.replay = self.dqn.replay
        self.opt = adamw(lr)
        self.ring_size = ring_size
        self.batch_size = batch_size
        self.warmup = warmup
        self.eps_start = eps_start
        self.eps_end = eps_end
        if eps_decay_steps is None:  # anneal over 60% of the run
            eps_decay_steps = max(1, int(0.6 * total_iters)) \
                if total_iters else 200
        self.eps_decay_steps = eps_decay_steps

    def init(self, generator):
        params = self.dqn.init(generator)
        online = sub(params, "online")
        obs_zero = torch.zeros(self.obs_space.shape,
                               dtype=self.obs_space.dtype, device=self.device)
        example = {"obs": obs_zero,
                   "action": torch.zeros((), dtype=torch.int32,
                                         device=self.device),
                   "reward": torch.zeros((), device=self.device),
                   "next_obs": obs_zero,
                   "done": torch.zeros((), dtype=torch.bool,
                                       device=self.device)}
        # the flat buffer, also when the Trainer has swapped a sharded
        # replay service into self.replay: it shards this state itself
        return TrainState(params, self.opt.init(online),
                          {"replay": self.dqn.replay.init(example)},
                          self._ring_init(online),
                          torch.zeros((), dtype=torch.int32,
                                      device=self.device))

    def epsilon(self, steps):
        """The annealed exploration rate after `steps` TrainState updates
        (warmup iterations count)."""
        frac = torch.clamp(steps.to(torch.float32) / self.eps_decay_steps,
                           0.0, 1.0)
        return self.eps_start + frac * (self.eps_end - self.eps_start)

    def partition_spec(self, state):
        """Only the online net is optimizer-updated (opt_state mirrors
        it); the target net and the update counter stay outside."""
        return sub(state.params, "online")

    def replace_partition(self, params, part):
        rest = {k: v for k, v in params.items()
                if not k.startswith("online/")}
        return rest if part is None else {**prefixed("online", part),
                                          **rest}

    def actor_policy(self, state, delay=0):
        return {**prefixed("net", self._ring_read(state.ring, delay)),
                "eps": self.epsilon(state.steps)}

    def learner_step(self, state, traj, boot_obs, generator,
                     grad_tx=None, param_tx=None):
        """Draws the replay's sampling noise from `generator` and runs
        `learner_step_noise`."""
        return self.learner_step_noise(
            state, traj, boot_obs,
            self.replay.noise(generator, self.batch_size), grad_tx,
            param_tx)

    @staticmethod
    def transitions(traj):
        """A (T, B) trajectory as T·B replay transitions. The rollout
        records the TRUE successor obs (pre-autoreset at episode
        boundaries), so replayed transitions are exact across resets."""
        flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))
        return {"obs": flat(traj["obs"]),
                "action": flat(traj["action"]).to(torch.int32),
                "reward": flat(traj["reward"]),
                "next_obs": flat(traj["next_obs"]),
                "done": flat(traj["done"])}

    def learner_step_noise(self, state, traj, boot_obs, noise,
                           grad_tx=None, param_tx=None):
        """The learner with the replay draw's noise given (the Gumbel
        vector of the fused draw). `grad_tx` exchanges the online net's
        gradients and `param_tx` mixes the online net after the update,
        every step, warmup included (the warmup select comes after), so
        every position makes the same collective calls."""
        replay = self.replay
        rstate = replay.add_batch(state.extra["replay"],
                                  self.transitions(traj))
        if self.dqn.prioritized:
            batch, idx, w = replay.sample_with(rstate, noise,
                                               self.batch_size)
        else:
            batch, idx = replay.sample_with(rstate, noise, self.batch_size)
            w = None
        new_params, opt_state, loss, td = self.dqn.update(
            state.params, state.opt_state, batch, w, self.opt, grad_tx,
            param_tx)
        warm = state.steps >= self.warmup
        if self.dqn.prioritized:
            # keep the Ape-X max-priority inserts during warmup: |td| of
            # the untrained net would under-prioritize early data
            updated = replay.update_priorities(rstate, idx, td)
            rstate = dict(rstate, prio=torch.where(warm, updated["prio"],
                                                   rstate["prio"]))
        # pure-collection warmup: keep filling the replay, hold the params
        params = select(warm, new_params, state.params)
        opt_state = select(warm, opt_state, state.opt_state)
        return TrainState(params, opt_state, {"replay": rstate},
                          self._ring_push(state.ring,
                                          sub(params, "online")),
                          state.steps + 1), {
            "loss": torch.where(warm, loss, 0.0)}


register("dqn", DQNAgent)
