"""EnvSpec: typed observation/action spaces for the env substrate (the
port of src/repro/envs/spec.py).

Everything read off an env's shape — policy construction, action
scaling, the serving engine's request padding — is derived from one
immutable `EnvSpec`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Space:
    """A (possibly bounded) array space.

    `n > 0` marks a discrete space with `n` categories (shape is then the
    shape of the integer action array, usually `()`); `n == 0` marks a
    continuous box with `low`/`high` bounds (None = unbounded).
    """
    shape: Tuple[int, ...]
    dtype: Any = torch.float32
    low: float = None
    high: float = None
    n: int = 0

    @property
    def discrete(self) -> bool:
        return self.n > 0

    @property
    def size(self) -> int:
        """Number of scalar entries (flattened width)."""
        return int(math.prod(self.shape)) if self.shape else 1

    @property
    def midpoint(self) -> float:
        lo = -1.0 if self.low is None else self.low
        hi = 1.0 if self.high is None else self.high
        return 0.5 * (lo + hi)

    @property
    def half_range(self) -> float:
        lo = -1.0 if self.low is None else self.low
        hi = 1.0 if self.high is None else self.high
        return 0.5 * (hi - lo)

    def sample(self, generator, n=None):
        """Uniform random elements (a leading batch of `n` if given), on
        the generator's device."""
        shape = self.shape if n is None else (n,) + self.shape
        dev = generator.device
        if self.discrete:
            return torch.randint(0, self.n, shape, generator=generator,
                                 device=dev, dtype=self.dtype)
        lo = -1.0 if self.low is None else self.low
        hi = 1.0 if self.high is None else self.high
        u = torch.rand(shape, generator=generator, device=dev,
                       dtype=self.dtype)
        return u * (hi - lo) + lo

    def contains(self, x) -> bool:
        """Host-side containment check over trailing `shape` dims."""
        x = torch.as_tensor(x)
        if self.shape and tuple(x.shape[-len(self.shape):]) != self.shape:
            return False
        if self.discrete:
            return bool(torch.all((x >= 0) & (x < self.n)))
        ok = torch.isfinite(x)
        if self.low is not None:
            ok = ok & (x >= self.low - 1e-5)
        if self.high is not None:
            ok = ok & (x <= self.high + 1e-5)
        return bool(torch.all(ok))


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """The immutable contract between an environment and its consumers.
    `episode_len` is the env's internal step cap (0 = none)."""
    name: str
    observation: Space
    action: Space
    episode_len: int = 0

    @property
    def obs_dim(self) -> int:
        return self.observation.size

    @property
    def n_actions(self) -> int:
        return self.action.n

    @property
    def act_dim(self) -> int:
        return 1 if self.action.discrete else self.action.size

    def replace(self, **kw) -> "EnvSpec":
        return dataclasses.replace(self, **kw)


def discrete(n: int, shape: Tuple[int, ...] = ()) -> Space:
    """Discrete action/observation space with `n` categories."""
    return Space(shape=shape, dtype=torch.int32, n=n)


def box(shape, low=None, high=None, dtype=torch.float32) -> Space:
    """Continuous box space."""
    return Space(shape=tuple(shape), dtype=dtype, low=low, high=high)
