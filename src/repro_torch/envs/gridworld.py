"""N×N gridworld over batched tensors (discrete, 4 actions).

Layout (grid size and goal placement) lives in the scenario, so a batch
of envs can mix sizes and goals; `gridworld-rand` re-draws both per
episode.
"""
import torch

from repro_torch.envs.api import Env
from repro_torch.envs.registry import register
from repro_torch.envs.spec import EnvSpec, box, discrete

_MOVES = ((0, 1), (0, -1), (1, 0), (-1, 0))


def _randint_below(generator, high):
    """Uniform integers in [0, high) for a tensor of per-env bounds."""
    u = torch.rand(high.shape, generator=generator, device=high.device)
    return torch.minimum((u * high).to(high.dtype), high - 1)


class GridWorld(Env):
    def __init__(self, n=8, max_steps=64, random_goal=False,
                 scenario=None, ranges=None):
        self.n = n
        self.max_steps = max_steps
        self.random_goal = random_goal
        super().__init__(scenario, ranges)

    @property
    def spec(self):
        return EnvSpec("gridworld",
                       observation=box((4,), low=0.0, high=1.0),
                       action=discrete(4),
                       episode_len=self.max_steps)

    def default_scenario(self):
        return {"n": torch.tensor(self.n, dtype=torch.int32),
                "goal": torch.tensor([self.n - 1, self.n - 1],
                                     dtype=torch.int32)}

    def sample_scenario(self, generator, n):
        scn = super().sample_scenario(generator, n)
        if self.random_goal:
            scn["goal"] = _randint_below(
                generator, scn["n"][:, None].expand(-1, 2))
        # keep the goal reachable when "n" is randomized/overridden
        scn["goal"] = torch.minimum(scn["goal"], scn["n"][:, None] - 1)
        return scn

    def reset_scenario(self, generator, scn):
        n = scn["n"]
        return {"pos": _randint_below(generator, n[:, None].expand(-1, 2)),
                "t": torch.zeros(n.shape, dtype=torch.int32,
                                 device=n.device)}

    def obs(self, state):
        scn = state["scn"]
        return (torch.cat([state["pos"], scn["goal"]], dim=-1).float()
                / scn["n"][:, None])

    def step(self, state, action):
        scn = state["scn"]
        delta = torch.tensor(_MOVES, dtype=torch.int32,
                             device=action.device)[action.long()]
        hi = scn["n"][:, None] - 1
        pos = torch.minimum(torch.clamp(state["pos"] + delta, min=0), hi)
        t = state["t"] + 1
        at_goal = torch.all(pos == scn["goal"], dim=-1)
        reward = torch.where(at_goal, 1.0, -0.01)
        done = at_goal | (t >= self.max_steps)
        s = {"pos": pos, "t": t, "scn": scn}
        return s, self.obs(s), reward, done

    def token_obs(self, state):
        """Integer token encoding (for transformer-trunk policies)."""
        return state["pos"][:, 0] * state["scn"]["n"] + state["pos"][:, 1]


register("gridworld", GridWorld)
register("gridworld-rand",
         lambda n=8, ranges=None, **kw: GridWorld(
             n=n, random_goal=True,
             ranges=dict({"n": (4, n)}, **(ranges or {})), **kw))
