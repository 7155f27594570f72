"""Debug environments for correctness testing (counterpart of
stoix_tpu/envs/debug.py: IdentityGame and SequenceGame)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
    # [N] int64 targets pinned by reset_to_level; None: a random target each step
    level: Optional[torch.Tensor] = None


class IdentityGame(Environment):
    """Observation is a one-hot target; reward 1 for matching it with the action.

    Optimal return over an episode of length `episode_length` is exactly
    `episode_length` — a learner failing to reach it has a plumbing bug.
    `reset_to_level(level, generator)` pins each env's target to its level
    for the whole episode (fixed evaluation levels, `env.eval_reset_fn`).
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

    def reset_to_level(self, level: torch.Tensor, generator: torch.Generator
                       ) -> Tuple[IdentityState, TimeStep]:
        """Reset every env to its level ([N] integers): its target, fixed."""
        device = generator.device
        level = level.to(device=device, dtype=torch.int64)
        num_envs = level.shape[0]
        state = IdentityState(
            generator, level, torch.zeros((num_envs,), dtype=torch.int32, device=device), level)
        return state, restart(self._obs(state), num_envs, device)

    def step(self, state: IdentityState, action: torch.Tensor) -> Tuple[IdentityState, TimeStep]:
        reward = (action == state.target).to(torch.float32)
        target = self._draw_targets(state.generator, state.target.shape[0])
        if state.level is not None:
            target = state.level
        next_state = IdentityState(state.generator, target, state.step_count + 1, state.level)
        obs = self._obs(next_state)
        done = next_state.step_count >= self._episode_length
        return next_state, select_step(done, termination(reward, obs), transition(reward, obs))


class SequenceState(NamedTuple):
    generator: torch.Generator
    cue: torch.Tensor  # [N] int64
    step_count: torch.Tensor  # [N] int32


class SequenceGame(Environment):
    """Memory task: the cue is visible only in the first observation; the
    agent earns reward 1 at the final step by repeating it. Needs recurrence
    for `delay` > 0. `reset_from_draws(cue, generator)` resets to given cues
    ([N] integers), so the tests can feed the JAX package's draws."""

    def __init__(self, num_actions: int = 4, delay: int = 4):
        self._num_actions = int(num_actions)
        self._delay = int(delay)

    def observation_space(self) -> Observation:
        return Observation(
            agent_view=spaces.Array((self._num_actions,), torch.float32),
            action_mask=spaces.Array((self._num_actions,), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(self._num_actions)

    def _obs(self, state: SequenceState) -> Observation:
        cue = state.cue
        visible = (state.step_count == 0)[:, None]
        view = torch.nn.functional.one_hot(cue, self._num_actions).to(torch.float32)
        return Observation(
            agent_view=torch.where(visible, view, 0.0),
            action_mask=torch.ones((cue.shape[0], self._num_actions), dtype=torch.float32,
                                   device=cue.device),
            step_count=state.step_count,
        )

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[SequenceState, TimeStep]:
        cue = torch.randint(0, self._num_actions, (num_envs,), generator=generator,
                            device=generator.device)
        return self.reset_from_draws(cue, generator)

    def reset_from_draws(self, cue: torch.Tensor, generator: torch.Generator
                         ) -> Tuple[SequenceState, TimeStep]:
        cue = cue.to(device=generator.device, dtype=torch.int64)
        num_envs = cue.shape[0]
        state = SequenceState(generator, cue,
                              torch.zeros((num_envs,), dtype=torch.int32, device=cue.device))
        return state, restart(self._obs(state), num_envs, cue.device)

    def step(self, state: SequenceState, action: torch.Tensor) -> Tuple[SequenceState, TimeStep]:
        next_count = state.step_count + 1
        at_end = next_count >= self._delay + 1
        reward = (at_end & (action == state.cue)).to(torch.float32)
        next_state = SequenceState(state.generator, state.cue, next_count)
        obs = self._obs(next_state)
        return next_state, select_step(at_end, termination(reward, obs), transition(reward, obs))
