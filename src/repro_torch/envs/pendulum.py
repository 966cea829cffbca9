"""Pendulum-v1 dynamics over batched tensors (continuous torque).

Mass/length/gravity live in the scenario; `pendulum-rand` draws a fresh
variant per episode. Torque and speed limits stay static — they define
the action bounds and obs normalization published in the spec.
"""
import math

import torch

from repro_torch.envs.api import Env
from repro_torch.envs.registry import register
from repro_torch.envs.spec import EnvSpec, box

# per-episode randomization bounds for the `pendulum-rand` family
RAND_RANGES = {"m": (0.7, 1.3), "l": (0.7, 1.3), "g": (8.0, 12.0)}


def _angle_normalize(x):
    return ((x + math.pi) % (2 * math.pi)) - math.pi


class Pendulum(Env):
    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    l = 1.0
    max_steps = 200

    @property
    def spec(self):
        return EnvSpec("pendulum",
                       observation=box((3,), low=-1.0, high=1.0),
                       action=box((1,), low=-self.max_torque,
                                  high=self.max_torque),
                       episode_len=self.max_steps)

    def default_scenario(self):
        return {"g": self.g, "m": self.m, "l": self.l}

    def reset_scenario(self, generator, scn):
        n, dev = scn["g"].shape[0], generator.device
        u = torch.rand((n, 2), generator=generator, device=dev)
        return {"th": u[:, 0] * (2 * math.pi) - math.pi,
                "thdot": u[:, 1] * 2.0 - 1.0,
                "t": torch.zeros((n,), dtype=torch.int32, device=dev)}

    def obs(self, state):
        return torch.stack([torch.cos(state["th"]), torch.sin(state["th"]),
                            state["thdot"] / self.max_speed], dim=-1)

    def step(self, state, action):
        scn = state["scn"]
        u = torch.clamp(action.reshape(-1), -self.max_torque,
                        self.max_torque)
        th, thdot = state["th"], state["thdot"]
        cost = (_angle_normalize(th) ** 2 + 0.1 * thdot ** 2
                + 0.001 * u ** 2)
        thdot = thdot + (3 * scn["g"] / (2 * scn["l"]) * torch.sin(th)
                         + 3.0 / (scn["m"] * scn["l"] ** 2) * u) * self.dt
        thdot = torch.clamp(thdot, -self.max_speed, self.max_speed)
        th = th + thdot * self.dt
        t = state["t"] + 1
        s = {"th": th, "thdot": thdot, "t": t, "scn": scn}
        return s, self.obs(s), -cost, t >= self.max_steps


register("pendulum", Pendulum)
register("pendulum-rand",
         lambda ranges=None, **kw: Pendulum(
             ranges=dict(RAND_RANGES, **(ranges or {})), **kw))
