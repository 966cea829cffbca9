"""Environment name registry — `envs.make("cartpole", **kw)`:
environments and their scenario variants self-register by name when
`repro_torch.envs` is imported."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.envs.api import Env

_REGISTRY: Dict[str, Callable[..., Env]] = {}


def register(name: str, factory: Callable[..., Env]) -> None:
    """Register an Env factory under `name` (called with **kwargs)."""
    _REGISTRY[name] = factory


def available():
    """Names of all registered environments."""
    import repro_torch.envs  # noqa: F401 — triggers self-registration
    return tuple(sorted(_REGISTRY))


def make(name: str, **kwargs) -> Env:
    """Construct a registered environment by name from config."""
    import repro_torch.envs  # noqa: F401 — triggers self-registration
    if name not in _REGISTRY:
        raise KeyError(f"unknown environment {name!r}; available: "
                       f"{', '.join(sorted(_REGISTRY))}")
    return _REGISTRY[name](**kwargs)
