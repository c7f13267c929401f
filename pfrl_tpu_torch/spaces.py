"""Minimal space specs: a copy of ``pfrl_tpu/spaces.py``'s ``Discrete``,
``Box`` (static metadata only: shapes, dtypes, bounds) and
``from_gym_space``, kept here so the port never imports the JAX package."""

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Discrete:
    n: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()

    @property
    def dtype(self):
        return np.int32

    def sample(self, np_random=np.random):
        return np_random.randint(self.n)

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n


@dataclasses.dataclass(frozen=True)
class Box:
    low: np.ndarray
    high: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "low", np.asarray(self.low, dtype=np.float32))
        object.__setattr__(self, "high", np.asarray(self.high, dtype=np.float32))

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.low.shape

    @property
    def dtype(self):
        return np.float32

    def sample(self, np_random=np.random):
        low = np.where(np.isfinite(self.low), self.low, -1.0)
        high = np.where(np.isfinite(self.high), self.high, 1.0)
        return np_random.uniform(low, high).astype(np.float32)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(
            np.all(x >= self.low) and np.all(x <= self.high)
        )


def box(low, high, shape=None) -> Box:
    if shape is not None:
        low = np.full(shape, low, dtype=np.float32)
        high = np.full(shape, high, dtype=np.float32)
    return Box(low=low, high=high)


def from_gym_space(space):
    """A gym or gymnasium ``Discrete`` or ``Box`` as the local spec type."""
    name = type(space).__name__
    if name == "Discrete":
        return Discrete(n=int(space.n))
    if name == "Box":
        return Box(low=np.asarray(space.low), high=np.asarray(space.high))
    raise NotImplementedError(f"Unsupported gym space: {space!r}")
