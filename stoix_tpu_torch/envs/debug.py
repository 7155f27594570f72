"""Debug environments for correctness testing (counterpart of
stoix_tpu/envs/debug.py, the IdentityGame subset)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from stoix_tpu_torch.envs import spaces
from stoix_tpu_torch.envs.core import Environment
from stoix_tpu_torch.envs.types import (
    Observation,
    TimeStep,
    restart,
    select_step,
    termination,
    transition,
)


class IdentityState(NamedTuple):
    generator: torch.Generator
    target: torch.Tensor  # [N] int64
    step_count: torch.Tensor  # [N] int32


class IdentityGame(Environment):
    """Observation is a one-hot target; reward 1 for matching it with the action.

    Optimal return over an episode of length `episode_length` is exactly
    `episode_length` — a learner failing to reach it has a plumbing bug.
    """

    def __init__(self, num_actions: int = 4, episode_length: int = 10):
        self._num_actions = int(num_actions)
        self._episode_length = int(episode_length)

    def observation_space(self) -> Observation:
        return Observation(
            agent_view=spaces.Array((self._num_actions,), torch.float32),
            action_mask=spaces.Array((self._num_actions,), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(self._num_actions)

    def _obs(self, state: IdentityState) -> Observation:
        target = state.target
        return Observation(
            agent_view=torch.nn.functional.one_hot(target, self._num_actions).to(torch.float32),
            action_mask=torch.ones(
                (target.shape[0], self._num_actions), dtype=torch.float32, device=target.device
            ),
            step_count=state.step_count,
        )

    def _draw_targets(self, generator: torch.Generator, num_envs: int) -> torch.Tensor:
        return torch.randint(
            0, self._num_actions, (num_envs,), generator=generator, device=generator.device
        )

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[IdentityState, TimeStep]:
        device = generator.device
        state = IdentityState(
            generator,
            self._draw_targets(generator, num_envs),
            torch.zeros((num_envs,), dtype=torch.int32, device=device),
        )
        return state, restart(self._obs(state), num_envs, device)

    def step(self, state: IdentityState, action: torch.Tensor) -> Tuple[IdentityState, TimeStep]:
        reward = (action == state.target).to(torch.float32)
        target = self._draw_targets(state.generator, state.target.shape[0])
        next_state = IdentityState(state.generator, target, state.step_count + 1)
        obs = self._obs(next_state)
        done = next_state.step_count >= self._episode_length
        return next_state, select_step(done, termination(reward, obs), transition(reward, obs))
