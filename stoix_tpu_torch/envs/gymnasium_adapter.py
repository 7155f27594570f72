"""Gymnasium adapter (counterpart of stoix_tpu/envs/gymnasium_adapter.py:
`VecGymToStoix` and `GymnasiumFactory`).

Wraps a vectorised Gymnasium env as a stateful Sebulba env that emits the
port's TimeStep and Observation, with the episode metrics kept on the host
in numpy. The outputs are host tensors, as the native pool's are
(envs/cvec.py). Gymnasium's SyncVectorEnv auto-resets inside its step and
reports the true final observation in its `final_obs` (or older
`final_observation`) info, which the adapter returns as `extras["next_obs"]`
for bootstrapping.

`gymnasium` is an optional dependency: it is imported only inside the
functions that need it.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from stoix_tpu_torch.envs import spaces
from stoix_tpu_torch.envs.cvec import host_tensor
from stoix_tpu_torch.envs.factory import EnvFactory
from stoix_tpu_torch.envs.types import Observation, TimeStep


class VecGymToStoix:
    """A gymnasium vector env behind the Sebulba env interface."""

    def __init__(self, envs: Any):
        self._envs = envs
        self._n = envs.num_envs
        self._ep_return = np.zeros((self._n,), np.float32)
        self._ep_length = np.zeros((self._n,), np.int32)

    @property
    def num_envs(self) -> int:
        return self._n

    @property
    def num_actions(self) -> int:
        import gymnasium as gym

        space = self._envs.single_action_space
        if isinstance(space, gym.spaces.Discrete):
            return int(space.n)
        return int(np.prod(space.shape))

    def observation_space(self) -> Observation:
        obs_shape = self._envs.single_observation_space.shape
        return Observation(
            agent_view=spaces.Array(tuple(obs_shape), torch.float32),
            action_mask=spaces.Array((self.num_actions,), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def observation_value(self) -> Observation:
        return spaces.tree_generate_value(self.observation_space())

    def action_space(self) -> spaces.Space:
        import gymnasium as gym

        space = self._envs.single_action_space
        if isinstance(space, gym.spaces.Discrete):
            return spaces.Discrete(int(space.n))
        return spaces.Box(low=space.low, high=space.high, shape=tuple(space.shape))

    def _observation(self, view: np.ndarray) -> Observation:
        return Observation(
            agent_view=host_tensor(np.asarray(view, np.float32)),
            action_mask=torch.ones((self._n, self.num_actions), dtype=torch.float32),
            step_count=host_tensor(self._ep_length),
        )

    def reset(self, *, seed: Optional[int] = None) -> TimeStep:
        obs, _info = self._envs.reset(seed=seed)
        self._ep_return[:] = 0
        self._ep_length[:] = 0
        return TimeStep(
            step_type=torch.zeros((self._n,), dtype=torch.int8),
            reward=torch.zeros((self._n,), dtype=torch.float32),
            discount=torch.ones((self._n,), dtype=torch.float32),
            observation=self._observation(obs),
            extras={
                "next_obs": self._observation(obs),
                "truncation": torch.zeros((self._n,), dtype=torch.bool),
                "episode_metrics": {
                    "episode_return": host_tensor(self._ep_return),
                    "episode_length": host_tensor(self._ep_length),
                    "is_terminal_step": torch.zeros((self._n,), dtype=torch.bool),
                },
            },
        )

    def step(self, action: Any) -> TimeStep:
        if isinstance(action, torch.Tensor):
            action = action.detach().cpu().numpy()
        obs, reward, terminated, truncated, infos = self._envs.step(np.asarray(action))
        reward = np.asarray(reward, np.float32)
        terminated = np.asarray(terminated, bool)
        truncated = np.asarray(truncated, bool)
        last = terminated | truncated

        self._ep_return += reward
        self._ep_length += 1
        ep_return = self._ep_return.copy()
        ep_length = self._ep_length.copy()
        self._ep_return[last] = 0
        self._ep_length[last] = 0

        # True successor observations (before the auto-reset) for bootstrapping.
        next_obs = np.asarray(obs, np.float32).copy()
        final = infos.get("final_observation", infos.get("final_obs"))
        if final is not None:
            for i, fo in enumerate(final):
                if fo is not None:
                    next_obs[i] = np.asarray(fo, np.float32)

        return TimeStep(
            step_type=host_tensor(np.where(last, np.int8(2), np.int8(1)).astype(np.int8)),
            reward=host_tensor(reward),
            discount=host_tensor(np.where(terminated, 0.0, 1.0).astype(np.float32)),
            observation=self._observation(obs),
            extras={
                "next_obs": self._observation(next_obs),
                "truncation": host_tensor(truncated),
                "episode_metrics": {
                    "episode_return": host_tensor(ep_return),
                    "episode_length": host_tensor(ep_length),
                    "is_terminal_step": host_tensor(last),
                },
            },
        )

    def close(self) -> None:
        self._envs.close()


class GymnasiumFactory(EnvFactory):
    """SyncVectorEnv batches of a Gymnasium task behind the Sebulba factory
    seam (thread-safe seed accounting through EnvFactory)."""

    def __call__(self, num_envs: int) -> VecGymToStoix:
        import gymnasium as gym

        self._next_seed(num_envs)  # keep thread-unique seed accounting
        fns = [lambda: gym.make(self._task_id, **self._kwargs) for _ in range(num_envs)]
        # SAME_STEP autoreset reports the true final observation in infos (the
        # 1.x default NEXT_STEP mode inserts a fabricated reset transition and
        # never exposes final observations).
        try:
            envs = gym.vector.SyncVectorEnv(fns, autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)
        except TypeError:  # older gymnasium: SAME_STEP was the only behaviour
            envs = gym.vector.SyncVectorEnv(fns)
        return VecGymToStoix(envs)
