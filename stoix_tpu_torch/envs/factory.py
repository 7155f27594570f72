"""Stateful environment factories, the Sebulba env seam (counterpart of
stoix_tpu/envs/factory.py: `EnvFactory`, `JaxToStateful`, `JaxEnvFactory`,
`EnvPoolFactory` and `make_factory`).

Sebulba actors consume STATEFUL batched envs: `envs.reset(seed=)` and
`envs.step(action)` return a TimeStep, the state living inside the object.
`TensorToStateful` wraps one of the port's batched tensor envs that way
(auto-reset, episode metrics, `extras["next_obs"]`), on an explicit device
with its own `torch.Generator`; like the JAX package's `JaxEnvFactory` it
defaults to the CPU: in Sebulba the envs live on the host, and inference
and learning run on the card. `env.backend: jax` keeps its name and selects
it; `env.backend: cvec` selects the native C++ pool (envs/cvec.py),
`gymnasium` a SyncVectorEnv behind envs/gymnasium_adapter.py and `envpool`
an envpool pool behind envs/envpool_adapter.py; both packages are optional
and imported only when their factory makes envs. Seeds are handed out under
a lock, so every actor thread draws unique envs.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import torch

from stoix_tpu_torch.envs.core import Environment
from stoix_tpu_torch.envs.types import TimeStep
from stoix_tpu_torch.envs.wrappers import AutoResetWrapper, RecordEpisodeMetrics


class EnvFactory:
    """Abstract factory with thread-safe unique seeding."""

    def __init__(self, task_id: str, init_seed: int = 42, **kwargs: Any):
        self._task_id = task_id
        self._seed = init_seed
        self._kwargs = kwargs
        self._lock = threading.Lock()

    def __call__(self, num_envs: int) -> Any:
        raise NotImplementedError

    def _next_seed(self, num_envs: int) -> int:
        with self._lock:
            seed = self._seed
            self._seed += num_envs
        return seed


class TensorToStateful:
    """A batched tensor env as a stateful Sebulba env on `device` (the CPU by
    default): `reset` and `step` return TimeSteps of tensors on that device;
    episodes auto-reset from the object's own generator, seeded by `seed`."""

    def __init__(self, env: Environment, num_envs: int, seed: int,
                 device: Optional[torch.device] = None):
        self._raw = env
        self._env = AutoResetWrapper(RecordEpisodeMetrics(env))
        self._num_envs = int(num_envs)
        self._device = torch.device(device if device is not None else "cpu")
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(int(seed))
        self._state = None

    @property
    def num_envs(self) -> int:
        return self._num_envs

    @property
    def device(self) -> torch.device:
        return self._device

    def observation_space(self):
        return self._env.observation_space()

    def observation_value(self):
        return self._env.observation_value()

    def action_space(self):
        return self._env.action_space()

    @property
    def num_actions(self) -> int:
        return self._env.num_actions

    def reset(self, *, seed: Optional[int] = None) -> TimeStep:
        if seed is not None:
            self._generator.manual_seed(int(seed))
        self._state, timestep = self._env.reset(self._generator, self._num_envs)
        return timestep

    def step(self, action: Any) -> TimeStep:
        action = torch.as_tensor(action).to(self._device)
        self._state, timestep = self._env.step(self._state, action)
        return timestep


class TensorEnvFactory(EnvFactory):
    """TensorToStateful instances of a registered env, on `device` (the CPU
    by default)."""

    def __init__(self, task_id: str, init_seed: int = 42, device: Optional[torch.device] = None,
                 suite: Optional[str] = None, **kwargs: Any):
        super().__init__(task_id, init_seed, **kwargs)
        self._device = torch.device(device if device is not None else "cpu")
        self._suite = suite

    def __call__(self, num_envs: int) -> TensorToStateful:
        from stoix_tpu_torch.envs.registry import make_single

        seed = self._next_seed(num_envs)
        env = make_single(self._task_id, self._suite, **self._kwargs)
        return TensorToStateful(env, num_envs, seed, self._device)


class EnvPoolFactory(EnvFactory):
    """EnvPool (C++ vectorised envs) pools behind `EnvPoolAdapter`; needs the
    optional `envpool` package and raises a clear error without it."""

    def __call__(self, num_envs: int) -> Any:
        try:
            import envpool
        except ImportError as e:
            raise ImportError(
                "EnvPoolFactory requires the optional 'envpool' package, which "
                "is not installed in this environment. Use TensorEnvFactory, or "
                "the native CVecEnvFactory (stoix_tpu_torch/envs/cvec.py) for the "
                "first-party C++ vectorized envs."
            ) from e
        from stoix_tpu_torch.envs.envpool_adapter import EnvPoolAdapter

        seed = self._next_seed(num_envs)
        # gym_reset_return_info: reset() -> (obs, info), the API the adapter takes.
        return EnvPoolAdapter(envpool.make(self._task_id, env_type="gymnasium",
                                           num_envs=num_envs, seed=seed,
                                           gym_reset_return_info=True, **self._kwargs))


def make_factory(config: Any) -> EnvFactory:
    """The Sebulba env factory of `config`, by `env.backend`: the native pool
    (cvec), the gymnasium or envpool adapters, else the port's tensor env on
    the CPU (jax, the default)."""
    scenario = (config.env.scenario.name if hasattr(config.env.scenario, "name")
                else config.env.scenario)
    kwargs = dict(config.env.get("kwargs", {}) or {})
    backend = str(config.env.get("backend", "jax"))
    seed = int(config.arch.seed)
    if backend == "envpool":
        return EnvPoolFactory(scenario, seed, **kwargs)
    if backend == "cvec":
        from stoix_tpu_torch.envs.cvec import CVecEnvFactory

        return CVecEnvFactory(scenario, seed, **kwargs)
    if backend == "gymnasium":
        from stoix_tpu_torch.envs.gymnasium_adapter import GymnasiumFactory

        return GymnasiumFactory(scenario, seed, **kwargs)
    return TensorEnvFactory(scenario, seed, suite=config.env.get("env_name"), **kwargs)
