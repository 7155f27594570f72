"""Core wrapper stack (counterpart of stoix_tpu/envs/wrappers.py).

    env -> EpisodeStepLimit? -> RecordEpisodeMetrics -> AutoResetWrapper

`timestep.extras["next_obs"]` is always the TRUE successor observation
(pre-auto-reset), so learners bootstrap correctly at truncations. The JAX
package's VmapWrapper has no counterpart: every env here is already batched
along a leading env axis. Auto-reset selects per env between the stepped
state and a freshly reset one with `torch.where`, with no host branching.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from stoix_tpu_torch.envs.core import Action, Environment, State, Wrapper
from stoix_tpu_torch.envs.types import StepType, TimeStep, tree_select


def _ensure_truncation(ts: TimeStep) -> None:
    """Guarantee the well-known extras["truncation"] key, derived from the
    timestep (LAST with discount > 0 is a truncation)."""
    if "truncation" not in ts.extras:
        ts.extras["truncation"] = ts.last() & (ts.discount > 0)


class StepLimitState(NamedTuple):
    inner: Any
    step_count: torch.Tensor


class EpisodeStepLimit(Wrapper):
    """Truncates episodes at `max_steps`: step_type LAST, discount kept at 1."""

    def __init__(self, env: Environment, max_steps: int):
        super().__init__(env)
        self._max_steps = int(max_steps)

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[State, TimeStep]:
        state, ts = self._env.reset(generator, num_envs)
        _ensure_truncation(ts)
        count = torch.zeros((num_envs,), dtype=torch.int32, device=ts.reward.device)
        return StepLimitState(state, count), ts

    def step(self, state: StepLimitState, action: Action) -> Tuple[State, TimeStep]:
        inner, ts = self._env.step(state.inner, action)
        count = state.step_count + 1
        truncate = (count >= self._max_steps) & ~ts.last()
        # The discount stays 1 on truncation: that is the whole point.
        ts = ts._replace(
            step_type=torch.where(truncate, StepType.LAST, ts.step_type)
        )
        inner_trunc = ts.extras.get("truncation")
        ts.extras["truncation"] = truncate if inner_trunc is None else truncate | inner_trunc
        return StepLimitState(inner, count), ts


class EpisodeMetricsState(NamedTuple):
    inner: Any
    episode_return: torch.Tensor
    episode_length: torch.Tensor


class RecordEpisodeMetrics(Wrapper):
    """Accumulates per-episode return/length into extras["episode_metrics"]."""

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[State, TimeStep]:
        state, ts = self._env.reset(generator, num_envs)
        device = ts.reward.device
        zero = torch.zeros((num_envs,), dtype=torch.float32, device=device)
        zero_len = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        ts.extras["episode_metrics"] = {
            "episode_return": zero,
            "episode_length": zero_len,
            "is_terminal_step": torch.zeros((num_envs,), dtype=torch.bool, device=device),
        }
        _ensure_truncation(ts)
        return EpisodeMetricsState(state, zero, zero_len), ts

    def step(self, state: EpisodeMetricsState, action: Action) -> Tuple[State, TimeStep]:
        inner, ts = self._env.step(state.inner, action)
        ep_return = state.episode_return + ts.reward
        ep_length = state.episode_length + 1
        done = ts.last()
        ts.extras["episode_metrics"] = {
            "episode_return": ep_return,
            "episode_length": ep_length,
            "is_terminal_step": done,
        }
        _ensure_truncation(ts)
        # Accumulators restart after a terminal step (auto-reset follows above us).
        next_state = EpisodeMetricsState(
            inner,
            torch.where(done, 0.0, ep_return),
            torch.where(done, 0, ep_length),
        )
        return next_state, ts


class AutoResetState(NamedTuple):
    inner: Any
    generator: torch.Generator


class AutoResetWrapper(Wrapper):
    """Resets ended episodes within `step`.

    The returned timestep keeps the terminal step_type/reward/discount but its
    `observation` becomes the first observation of the new episode, while
    `extras["next_obs"]` carries the true terminal observation for bootstrapping.
    """

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[State, TimeStep]:
        inner, ts = self._env.reset(generator, num_envs)
        ts.extras["next_obs"] = ts.observation
        return AutoResetState(inner, generator), ts

    def step(self, state: AutoResetState, action: Action) -> Tuple[State, TimeStep]:
        inner, ts = self._env.step(state.inner, action)
        # Every env draws a reset state, as the JAX wrapper does under vmap;
        # the ended ones take it.
        reset_state, reset_ts = self._env.reset(state.generator, action.shape[0])
        done = ts.last()
        next_inner = tree_select(done, reset_state, inner)
        new_obs = tree_select(done, reset_ts.observation, ts.observation)
        ts = ts._replace(observation=new_obs, extras={**ts.extras, "next_obs": ts.observation})
        return AutoResetState(next_inner, state.generator), ts


def apply_core_wrappers(env: Environment, max_episode_steps: Optional[int] = None) -> Environment:
    """The canonical wrapper composition. The batch size is the `num_envs`
    handed to `reset`."""
    if max_episode_steps is not None and max_episode_steps > 0:
        env = EpisodeStepLimit(env, max_episode_steps)
    env = RecordEpisodeMetrics(env)
    return AutoResetWrapper(env)
