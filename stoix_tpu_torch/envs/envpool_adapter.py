"""EnvPool adapter: full-Atari reset and lives semantics for the Sebulba path
(counterpart of stoix_tpu/envs/envpool_adapter.py: `EnvPoolAdapter`).

The three behaviours that carry the reference's Atari fidelity:

  1. **done-ids autoreset**: envpool's own autoreset returns the terminal
     observation on the done step and the reset observation one step LATER;
     the Sebulba rollout wants the reset observation at once. The adapter
     therefore issues a second `env.step(zeros, done_ids)` restricted to the
     finished envs and splices their reset observations in. The true
     terminal successor stays in `extras["next_obs"]` for bootstrapping.
  2. **lives**: on Atari losing a life ends an envpool episode; the episode
     metrics conclude only when every life is gone (`info["lives"] == 0`),
     or when the step limit cuts the game short.
  3. **elapsed_step truncation**: reaching `max_episode_steps` by
     `info["elapsed_step"]` is a truncation (discount stays 1), not a
     termination.

It returns the native pool's TimeStep contract (envs/cvec.py): host tensors
of Observation(agent_view, action_mask, step_count) and extras {next_obs,
truncation, episode_metrics}, the episode metrics in float64 and int64 as
the JAX adapter keeps them. The pool it wraps is any object with envpool's
surface (gymnasium API with `gym_reset_return_info`, partial steps by env
ids, `spec.config.max_episode_steps`); `envpool` itself is an optional
dependency that only `EnvPoolFactory` imports.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from stoix_tpu_torch.envs import spaces
from stoix_tpu_torch.envs.cvec import host_tensor
from stoix_tpu_torch.envs.types import Observation, TimeStep


class EnvPoolAdapter:
    """Wrap a constructed envpool env (gymnasium API, gym_reset_return_info)."""

    def __init__(self, env: Any, has_lives: Optional[bool] = None):
        self._env = env
        obs, _ = env.reset()
        self._n = int(obs.shape[0])
        self._obs_shape = tuple(obs.shape[1:])
        self._num_actions = int(env.action_space.n)
        self._max_episode_steps = int(env.spec.config.max_episode_steps)

        if has_lives is None:
            # Probe: Atari tasks report a positive lives counter after one
            # zero-action step.
            info = env.step(np.zeros(self._n, dtype=np.int32))[-1]
            has_lives = bool("lives" in info and np.sum(info["lives"]) > 0)
            obs, _ = env.reset()
        self._has_lives = bool(has_lives)

        self._obs = obs
        self._elapsed = np.zeros(self._n, dtype=np.int64)
        # Running episode accumulators and the last CONCLUDED episode's
        # metrics (concluded: every life gone with lives, else any done).
        self._run_return = np.zeros(self._n, dtype=np.float64)
        self._run_length = np.zeros(self._n, dtype=np.int64)
        self._ep_return = np.zeros(self._n, dtype=np.float64)
        self._ep_length = np.zeros(self._n, dtype=np.int64)

    @property
    def num_envs(self) -> int:
        return self._n

    @property
    def num_actions(self) -> int:
        return self._num_actions

    def observation_space(self) -> Observation:
        return Observation(
            agent_view=spaces.Array(self._obs_shape, torch.float32),
            action_mask=spaces.Array((self._num_actions,), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def observation_value(self) -> Observation:
        return spaces.tree_generate_value(self.observation_space())

    def action_space(self) -> spaces.Space:
        return spaces.Discrete(self._num_actions)

    def _observation(self, view: np.ndarray, counts: np.ndarray) -> Observation:
        return Observation(
            agent_view=host_tensor(np.asarray(view, np.float32)),
            action_mask=torch.ones((self._n, self._num_actions), dtype=torch.float32),
            step_count=host_tensor(counts.astype(np.int32)),
        )

    def reset(self, *, seed: Optional[int] = None) -> TimeStep:
        del seed  # envpool seeds at construction
        obs, _ = self._env.reset()
        self._obs = obs
        self._elapsed[:] = 0
        self._run_return[:] = 0
        self._run_length[:] = 0
        self._ep_return[:] = 0
        self._ep_length[:] = 0
        zeros = np.zeros(self._n, np.int64)
        return TimeStep(
            step_type=torch.zeros(self._n, dtype=torch.int8),
            reward=torch.zeros(self._n, dtype=torch.float32),
            discount=torch.ones(self._n, dtype=torch.float32),
            observation=self._observation(obs, zeros),
            extras={
                "next_obs": self._observation(obs, zeros),
                "truncation": torch.zeros(self._n, dtype=torch.bool),
                "episode_metrics": {
                    "episode_return": torch.zeros(self._n, dtype=torch.float64),
                    "episode_length": torch.zeros(self._n, dtype=torch.int64),
                    "is_terminal_step": torch.zeros(self._n, dtype=torch.bool),
                },
            },
        )

    def step(self, action: Any) -> TimeStep:
        if isinstance(action, torch.Tensor):
            action = action.detach().cpu().numpy()
        action = np.asarray(action, np.int32).reshape(self._n)
        obs, rewards, terminated, env_truncated, info = self._env.step(action)
        terminated = np.asarray(terminated, bool)
        elapsed = np.asarray(info.get("elapsed_step", self._elapsed + 1))
        # The pool's own truncated flag OR the elapsed-step check: a pool that
        # truncates on a condition the counter misses would otherwise desync
        # the done-ids reset splice one step later.
        truncated = np.logical_and(
            np.logical_or(np.asarray(env_truncated, bool), elapsed >= self._max_episode_steps),
            ~terminated,
        )
        ep_done = np.logical_or(terminated, truncated)

        # True terminal successors, before any reset splice (bootstrapping).
        next_obs = np.array(obs, copy=True)

        # done-ids autoreset: step ONLY the finished envs with a zero action
        # for their reset observations.
        done_ids = np.where(ep_done)[0]
        if len(done_ids) > 0:
            reset_obs = self._env.step(np.zeros(len(done_ids), dtype=np.int32), done_ids)[0]
            obs = np.array(obs, copy=True)
            obs[done_ids] = reset_obs

        metric_reward = np.asarray(info.get("reward", rewards), np.float64)
        new_return = self._run_return + metric_reward
        new_length = self._run_length + 1

        if self._has_lives:
            # A game concludes when every life is gone, or when the step limit
            # cuts it with lives left (its run would otherwise merge into the
            # next game's metrics).
            concluded = np.logical_or(
                np.logical_and(ep_done, np.asarray(info["lives"]) == 0), truncated)
        else:
            concluded = ep_done
        self._ep_return = np.where(concluded, new_return, self._ep_return)
        self._ep_length = np.where(concluded, new_length, self._ep_length)
        self._run_return = np.where(concluded, 0.0, new_return)
        self._run_length = np.where(concluded, 0, new_length)

        self._elapsed = np.where(ep_done, 0, elapsed)
        self._obs = obs

        counts = np.where(ep_done, 0, elapsed)
        return TimeStep(
            step_type=host_tensor(np.where(ep_done, np.int8(2), np.int8(1)).astype(np.int8)),
            reward=host_tensor(np.asarray(rewards, np.float32)),
            discount=host_tensor(np.where(terminated, 0.0, 1.0).astype(np.float32)),
            observation=self._observation(obs, counts),
            extras={
                "next_obs": self._observation(next_obs, elapsed),
                "truncation": host_tensor(truncated),
                "episode_metrics": {
                    "episode_return": host_tensor(self._ep_return),
                    "episode_length": host_tensor(self._ep_length),
                    "is_terminal_step": host_tensor(concluded),
                },
            },
        )

    def close(self) -> None:
        self._env.close()
