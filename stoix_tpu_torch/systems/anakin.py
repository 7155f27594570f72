"""Anakin learner-construction helpers shared by system files (counterpart of
stoix_tpu/systems/anakin.py: `head_kwargs_for_env` and
`reset_envs_for_anakin`, plus the seeding the JAX package does with
`jax.random.split`)."""

from __future__ import annotations

import inspect
from typing import Any, List, Tuple

import numpy as np
import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.envs import spaces as env_spaces
from stoix_tpu_torch.utils.config import _import_target


def head_kwargs_for_env(head_cfg: Any, env: envs.Environment) -> dict:
    """Infer action-head constructor kwargs from the env's action space.
    Explicit values in the network YAML win over inferred ones."""
    target = _import_target(head_cfg["_target_"])
    params = inspect.signature(target).parameters
    space = env.action_space()
    kwargs: dict = {}

    def bound(v: Any) -> Any:
        arr = np.asarray(v)
        return float(arr) if arr.ndim == 0 or np.all(arr == arr.flat[0]) else arr.tolist()

    if "num_actions" in params:
        kwargs["num_actions"] = env.num_actions
    if "action_dim" in params:
        kwargs["action_dim"] = env.num_actions
    if "minimum" in params and isinstance(space, env_spaces.Box):
        kwargs["minimum"] = bound(space.low)
    if "maximum" in params and isinstance(space, env_spaces.Box):
        kwargs["maximum"] = bound(space.high)
    return {k: v for k, v in kwargs.items() if k not in head_cfg}


def make_seeds(seed: int, count: int) -> List[int]:
    """`count` independent 63-bit seeds derived from one run seed (the
    port's `jax.random.split`)."""
    children = np.random.SeedSequence(int(seed)).spawn(count)
    return [int(c.generate_state(1, np.uint64)[0] >> np.uint64(1)) for c in children]


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    return generator


def reset_envs_for_anakin(
    env: envs.Environment, config: Any, generator: torch.Generator
) -> Tuple[Any, Any]:
    """Reset all `arch.total_num_envs` envs on the generator's device. Under
    `arch.update_batch_size` U they are U groups of `total_num_envs // U`
    along the env axis, replica u's the u-th."""
    return env.reset(generator, int(config.arch.total_num_envs))
