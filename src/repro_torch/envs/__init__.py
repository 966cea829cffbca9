"""Environment substrate: spec'd, registered, scenario-batched.

  env = envs.make("cartpole-rand")          # name registry
  env.spec                                  # typed obs/action spaces
  state = env.reset(generator, n)           # a batch of n envs

Wrappers and the `-norm` / `-repeat` variants are not ported yet.
"""
from repro_torch.envs.api import Env  # noqa: F401
from repro_torch.envs.spec import EnvSpec, Space, box, discrete  # noqa: F401
from repro_torch.envs.registry import available, make, register  # noqa: F401
from repro_torch.envs.cartpole import CartPole  # noqa: F401
from repro_torch.envs.pendulum import Pendulum  # noqa: F401
from repro_torch.envs.gridworld import GridWorld  # noqa: F401
