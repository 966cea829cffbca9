"""CartPole-v1 dynamics over batched tensors (discrete, 2 actions).

Physics constants live in the scenario (`state["scn"]`, one row per
env); the `cartpole-rand` family draws a fresh variant per episode.
"""
import math

import torch

from repro_torch.envs.api import Env
from repro_torch.envs.registry import register
from repro_torch.envs.spec import EnvSpec, box, discrete

# per-episode randomization bounds for the `cartpole-rand` family
RAND_RANGES = {"masspole": (0.05, 0.2), "length": (0.3, 0.7),
               "force_mag": (8.0, 12.0)}


class CartPole(Env):
    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    length = 0.5
    force_mag = 10.0
    tau = 0.02
    x_lim = 2.4
    theta_lim = 12 * math.pi / 180
    max_steps = 200

    @property
    def spec(self):
        return EnvSpec("cartpole",
                       observation=box((4,)),
                       action=discrete(2),
                       episode_len=self.max_steps)

    def default_scenario(self):
        return {"gravity": self.gravity, "masscart": self.masscart,
                "masspole": self.masspole, "length": self.length,
                "force_mag": self.force_mag}

    def reset_scenario(self, generator, scn):
        n = scn["gravity"].shape[0]
        u = torch.rand((n, 4), generator=generator, device=generator.device)
        return {"s": u * 0.1 - 0.05,
                "t": torch.zeros((n,), dtype=torch.int32,
                                 device=generator.device)}

    def obs(self, state):
        return state["s"]

    def step(self, state, action):
        scn = state["scn"]
        x, x_dot, th, th_dot = state["s"].unbind(-1)
        force = torch.where(action > 0, scn["force_mag"], -scn["force_mag"])
        total_mass = scn["masscart"] + scn["masspole"]
        pml = scn["masspole"] * scn["length"]
        costh, sinth = torch.cos(th), torch.sin(th)
        temp = (force + pml * th_dot ** 2 * sinth) / total_mass
        th_acc = (scn["gravity"] * sinth - costh * temp) / (
            scn["length"] * (4.0 / 3.0 - scn["masspole"] * costh ** 2
                             / total_mass))
        x_acc = temp - pml * th_acc * costh / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * x_acc
        th = th + self.tau * th_dot
        th_dot = th_dot + self.tau * th_acc
        s = torch.stack([x, x_dot, th, th_dot], dim=-1)
        t = state["t"] + 1
        done = ((x.abs() > self.x_lim) | (th.abs() > self.theta_lim)
                | (t >= self.max_steps))
        return ({"s": s, "t": t, "scn": scn}, s, torch.ones_like(x), done)


register("cartpole", CartPole)
register("cartpole-rand",
         lambda ranges=None, **kw: CartPole(
             ranges=dict(RAND_RANGES, **(ranges or {})), **kw))
