"""Environment substrate: spec'd, registered, wrapped, scenario-batched.

  env = envs.make("cartpole-rand")          # name registry
  env.spec                                  # typed obs/action spaces
  state = env.reset(generator, n)           # a batch of n envs

See repro_torch.envs.api for the batched Env protocol and
repro_torch.envs.wrappers for the wrapper stack.
"""
from repro_torch.envs.api import Env  # noqa: F401
from repro_torch.envs.spec import EnvSpec, Space, box, discrete  # noqa: F401
from repro_torch.envs.registry import available, make, register  # noqa: F401
from repro_torch.envs.wrappers import (ActionRepeat,  # noqa: F401
                                       ObsNormalize, RewardScale,
                                       TimeLimit, Wrapper)
from repro_torch.envs.cartpole import CartPole  # noqa: F401
from repro_torch.envs.pendulum import Pendulum  # noqa: F401
from repro_torch.envs.gridworld import GridWorld  # noqa: F401

# wrapped variants: the substrate carries composed workloads
register("pendulum-norm",
         lambda **kw: ObsNormalize(RewardScale(Pendulum(**kw), 0.1)))
register("cartpole-repeat",
         lambda repeat=2, max_steps=100, **kw: ActionRepeat(
             TimeLimit(CartPole(**kw), max_steps), repeat))
