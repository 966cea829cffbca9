"""Deep evolutionary RL (survey §7), the port of src/repro/core/evo: ES,
Deep GA with its seed-chain encoding, and ERL. A population is a batch on
the device: the members' flat parameter vectors a (P, n) tensor, their
episodes one batch of P envs (core.rollout.episode_return)."""
from repro_torch.core.evo.es import ES, centered_ranks  # noqa: F401
from repro_torch.core.evo.ga import DeepGA  # noqa: F401
from repro_torch.core.evo.erl import ERL  # noqa: F401
