from repro_torch.core.algos.ppo import PPO, PPOAgent  # noqa: F401
from repro_torch.core.algos.impala import IMPALA, IMPALAAgent  # noqa: F401
from repro_torch.core.algos.a3c import A3C, A3CAgent  # noqa: F401
from repro_torch.core.algos.dqn import DQN, DQNAgent  # noqa: F401
