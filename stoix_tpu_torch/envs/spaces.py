"""Observation and action specs (counterpart of stoix_tpu/envs/spaces.py,
the Array, Box and Discrete subset).

Spaces are static Python objects describing ONE env's values; the batched
envs add the leading env axis. They let networks size their layers and
wrappers read shapes without running the env.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch


class Space:
    """Base class for all spaces."""

    def generate_value(self) -> torch.Tensor:
        """A zero-like value conforming to this space (for sizing networks)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Array(Space):
    """An unbounded array space with fixed shape and dtype."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    name: str = "array"

    def generate_value(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype)


@dataclasses.dataclass(frozen=True)
class Box(Space):
    """A bounded continuous space. `low`/`high` may be scalars or arrays."""

    low: Any
    high: Any
    shape: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32
    name: str = "box"

    def __post_init__(self) -> None:
        if not self.shape:
            inferred = np.broadcast(np.asarray(self.low), np.asarray(self.high)).shape
            object.__setattr__(self, "shape", tuple(inferred))

    def generate_value(self) -> torch.Tensor:
        mid = (np.asarray(self.low, np.float64) + np.asarray(self.high, np.float64)) / 2.0
        mid = np.where(np.isfinite(mid), mid, 0.0)
        return torch.as_tensor(np.broadcast_to(mid, self.shape).copy(), dtype=self.dtype)

    def sample(self, generator: torch.Generator, batch: Tuple[int, ...] = (),
               uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`batch` values uniform on [low, high): low + u (high - low), u from
        `generator` on its device unless given, as the JAX package's
        `Box.sample` forms them."""
        device = generator.device if uniform is None else uniform.device
        low = torch.as_tensor(np.broadcast_to(np.asarray(self.low), self.shape).copy(),
                              dtype=self.dtype).to(device)
        high = torch.as_tensor(np.broadcast_to(np.asarray(self.high), self.shape).copy(),
                               dtype=self.dtype).to(device)
        if uniform is None:
            uniform = torch.rand(tuple(batch) + tuple(self.shape), generator=generator,
                                 device=device, dtype=self.dtype)
        return low + uniform * (high - low)


@dataclasses.dataclass(frozen=True)
class Discrete(Space):
    """A discrete space {0, ..., num_values - 1}."""

    num_values: int
    dtype: torch.dtype = torch.int64
    name: str = "discrete"

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()

    def generate_value(self) -> torch.Tensor:
        return torch.zeros((), dtype=self.dtype)


def tree_generate_value(spec: Any) -> Any:
    """Dummy values for a NamedTuple, dict or sequence of spaces."""
    if isinstance(spec, Space):
        return spec.generate_value()
    if hasattr(spec, "_fields"):
        return type(spec)(*(tree_generate_value(s) for s in spec))
    if isinstance(spec, dict):
        return {k: tree_generate_value(v) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return type(spec)(tree_generate_value(v) for v in spec)
    raise TypeError(f"Cannot generate value for spec of type {type(spec)}")


def num_actions(action_space: Space) -> int:
    """Flat action dimensionality used for network head sizing."""
    if isinstance(action_space, Discrete):
        return int(action_space.num_values)
    if isinstance(action_space, (Box, Array)):
        return int(np.prod(action_space.shape)) if action_space.shape else 1
    raise TypeError(f"Unsupported action space {type(action_space)}")
