"""Core wrapper stack (counterpart of stoix_tpu/envs/wrappers.py).

    env -> FlattenObservationWrapper? -> EpisodeStepLimit? -> RecordEpisodeMetrics
        -> AutoResetWrapper | CachedAutoResetWrapper | OptimisticResetVmapWrapper

`timestep.extras["next_obs"]` is always the TRUE successor observation
(pre-auto-reset), so learners bootstrap correctly at truncations. The JAX
package's VmapWrapper has no counterpart: every env here is already batched
along a leading env axis. Auto-reset selects per env between the stepped
state and a reset one with `torch.where`, with no host branching. An env's
randomness lives in the `torch.Generator` its state holds, so a replayed
(cached or shared) reset state draws fresh numbers from it: the JAX
package's re-seeding of replayed PRNG keys has nothing to do here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from stoix_tpu_torch.envs.core import Action, Environment, State, Wrapper
from stoix_tpu_torch.envs.types import StepType, TimeStep, tree_select
from stoix_tpu_torch.utils.tree import tree_map


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
        return self._wrap_reset(*self._env.reset(generator, num_envs))

    def reset_to_level(self, level: torch.Tensor, generator: torch.Generator
                       ) -> Tuple[State, TimeStep]:
        return self._wrap_reset(*self._env.reset_to_level(level, generator))

    def _wrap_reset(self, state: State, ts: TimeStep) -> Tuple[State, TimeStep]:
        _ensure_truncation(ts)
        count = torch.zeros(ts.reward.shape, dtype=torch.int32, device=ts.reward.device)
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
        return self._wrap_reset(*self._env.reset(generator, num_envs))

    def reset_to_level(self, level: torch.Tensor, generator: torch.Generator
                       ) -> Tuple[State, TimeStep]:
        return self._wrap_reset(*self._env.reset_to_level(level, generator))

    def _wrap_reset(self, state: State, ts: TimeStep) -> Tuple[State, TimeStep]:
        shape, device = ts.reward.shape, ts.reward.device
        zero = torch.zeros(shape, dtype=torch.float32, device=device)
        zero_len = torch.zeros(shape, dtype=torch.int32, device=device)
        ts.extras["episode_metrics"] = {
            "episode_return": zero,
            "episode_length": zero_len,
            "is_terminal_step": torch.zeros(shape, dtype=torch.bool, device=device),
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


class CachedAutoResetState(NamedTuple):
    inner: Any
    cached_state: Any
    cached_obs: Any


class CachedAutoResetWrapper(Wrapper):
    """Auto-reset that replays each env's episode-initial state instead of
    running `reset` every step (the JAX package's CachedAutoResetWrapper):
    an ended env takes back the state and observation its first reset gave
    it. The generators the state holds keep advancing, so a replayed episode
    does not replay its random draws."""

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[State, TimeStep]:
        inner, ts = self._env.reset(generator, num_envs)
        ts.extras["next_obs"] = ts.observation
        return CachedAutoResetState(inner, inner, ts.observation), ts

    def step(self, state: CachedAutoResetState, action: Action) -> Tuple[State, TimeStep]:
        inner, ts = self._env.step(state.inner, action)
        done = ts.last()
        next_inner = tree_select(done, state.cached_state, inner)
        new_obs = tree_select(done, state.cached_obs, ts.observation)
        ts = ts._replace(observation=new_obs, extras={**ts.extras, "next_obs": ts.observation})
        return CachedAutoResetState(next_inner, state.cached_state, state.cached_obs), ts


class FlattenObservationWrapper(Wrapper):
    """Flattens a structured (grid, pixel) agent_view to [N, features] so MLP
    torsos can take it. Applied to the raw env, below the core stack, so
    `extras["next_obs"]` is flat too."""

    def __init__(self, env: Environment):
        super().__init__(env)
        shape = env.observation_space().agent_view.shape
        self._feature_rank = len(shape)
        self._flat_dim = 1
        for size in shape:
            self._flat_dim *= int(size)

    def _flatten(self, ts: TimeStep) -> TimeStep:
        view = ts.observation.agent_view
        shape = view.shape[: view.ndim - self._feature_rank] + (self._flat_dim,)
        return ts._replace(observation=ts.observation._replace(agent_view=view.reshape(shape)))

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[State, TimeStep]:
        state, ts = self._env.reset(generator, num_envs)
        return state, self._flatten(ts)

    def reset_to_level(self, level: torch.Tensor, generator: torch.Generator
                       ) -> Tuple[State, TimeStep]:
        state, ts = self._env.reset_to_level(level, generator)
        return state, self._flatten(ts)

    def step(self, state: State, action: Action) -> Tuple[State, TimeStep]:
        state, ts = self._env.step(state, action)
        return state, self._flatten(ts)

    def observation_space(self) -> Any:
        obs = self._env.observation_space()
        return obs._replace(
            agent_view=dataclasses.replace(obs.agent_view, shape=(self._flat_dim,)))


class OptimisticResetState(NamedTuple):
    inner: Any
    generator: torch.Generator


class OptimisticResetVmapWrapper(Wrapper):
    """Auto-reset that computes only `num_envs / reset_ratio` reset states a
    step (the JAX package's OptimisticResetVmapWrapper): env i takes reset
    slot i % (num_envs / reset_ratio) when it ends, so ended envs may share a
    reset state. With reset_ratio 1 it behaves as AutoResetWrapper."""

    def __init__(self, env: Environment, num_envs: int, reset_ratio: int = 16):
        super().__init__(env)
        if num_envs % reset_ratio != 0:
            raise ValueError(
                f"num_envs ({num_envs}) must be divisible by reset_ratio ({reset_ratio}); "
                "a silent fallback would defeat the amortization this wrapper exists for."
            )
        self._num_envs = int(num_envs)
        self._num_resets = max(1, int(num_envs) // int(reset_ratio))

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[State, TimeStep]:
        inner, ts = self._env.reset(generator, num_envs)
        ts.extras["next_obs"] = ts.observation
        return OptimisticResetState(inner, generator), ts

    def step(self, state: OptimisticResetState, action: Action) -> Tuple[State, TimeStep]:
        inner, ts = self._env.step(state.inner, action)
        reset_state, reset_ts = self._env.reset(state.generator, self._num_resets)
        slot = torch.arange(self._num_envs, device=action.device) % self._num_resets
        gathered_state = tree_map(lambda x: x[slot], reset_state)
        gathered_obs = tree_map(lambda x: x[slot], reset_ts.observation)
        done = ts.last()
        next_inner = tree_select(done, gathered_state, inner)
        new_obs = tree_select(done, gathered_obs, ts.observation)
        ts = ts._replace(observation=new_obs, extras={**ts.extras, "next_obs": ts.observation})
        return OptimisticResetState(next_inner, state.generator), ts


def apply_core_wrappers(
    env: Environment,
    num_envs: Optional[int] = None,
    *,
    max_episode_steps: Optional[int] = None,
    use_optimistic_reset: bool = False,
    reset_ratio: int = 16,
    use_cached_auto_reset: bool = False,
) -> Environment:
    """The canonical wrapper composition. The batch size is the `num_envs`
    handed to `reset`; the optimistic reset also needs it here."""
    if max_episode_steps is not None and max_episode_steps > 0:
        env = EpisodeStepLimit(env, max_episode_steps)
    env = RecordEpisodeMetrics(env)
    if use_optimistic_reset:
        if num_envs is None:
            raise ValueError("the optimistic reset needs num_envs")
        return OptimisticResetVmapWrapper(env, num_envs=num_envs, reset_ratio=reset_ratio)
    return CachedAutoResetWrapper(env) if use_cached_auto_reset else AutoResetWrapper(env)
