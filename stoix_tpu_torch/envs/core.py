"""Batched Environment API (counterpart of stoix_tpu/envs/core.py).

    state, timestep = env.reset(generator, num_envs)
    state, timestep = env.step(state, action)

Every env steps a whole batch at once: tensors carry a leading env axis and
one tensor op advances every env, on the device of the generator that reset
it. Where the JAX envs carry a PRNG key inside their state, these carry the
`torch.Generator` they draw from.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from stoix_tpu_torch.envs import spaces
from stoix_tpu_torch.envs.types import TimeStep

State = Any
Action = torch.Tensor


class Environment:
    """Base class for batched tensor environments."""

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[State, TimeStep]:
        raise NotImplementedError

    def step(self, state: State, action: Action) -> Tuple[State, TimeStep]:
        raise NotImplementedError

    def observation_space(self) -> Any:
        """NamedTuple of spaces matching the (per-env) observation."""
        raise NotImplementedError

    def action_space(self) -> spaces.Space:
        raise NotImplementedError

    def observation_value(self) -> Any:
        """A dummy (unbatched) observation for sizing networks."""
        return spaces.tree_generate_value(self.observation_space())

    @property
    def num_actions(self) -> int:
        return spaces.num_actions(self.action_space())


class Wrapper(Environment):
    """Delegating base wrapper."""

    def __init__(self, env: Environment):
        self._env = env

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[State, TimeStep]:
        return self._env.reset(generator, num_envs)

    def step(self, state: State, action: Action) -> Tuple[State, TimeStep]:
        return self._env.step(state, action)

    def observation_space(self) -> Any:
        return self._env.observation_space()

    def action_space(self) -> spaces.Space:
        return self._env.action_space()
