"""Anakin learner-construction helpers shared by system files (counterpart of
stoix_tpu/systems/anakin.py: `head_kwargs_for_env`, `reset_envs_for_anakin`
and `broadcast_to_update_batch`, plus the seeding the JAX package does with
`jax.random.split` and the replica loop that stands in for its
`vmap(axis_name="batch")` over `arch.update_batch_size`)."""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.envs import spaces as env_spaces
from stoix_tpu_torch.utils.config import _import_target
from stoix_tpu_torch.utils.tree import tree_map, tree_stack


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


# ---------------------------------------------------------------- replicas
#
# Under `arch.update_batch_size` U > 1 a learner holds U replicas: params and
# optimizer states with a leading [U] axis, one generator a replica, and the
# envs in U groups of `total_num_envs // U`, replica u's the u-th.


def broadcast_to_update_batch(tree: Any, update_batch: int) -> Any:
    """U identical copies of `tree` along a new leading axis (itself at U = 1)."""
    return tree if update_batch == 1 else tree_stack([tree] * update_batch)


def split_replicas(tree: Any, update_batch: int) -> List[Any]:
    """The U replicas of a [U]-leading tree (the tree itself at U = 1)."""
    if update_batch == 1:
        return [tree]
    return [tree_map(lambda x: x[u], tree) for u in range(update_batch)]


def join_replicas(trees: Sequence[Any]) -> Any:
    """The inverse of `split_replicas`."""
    return trees[0] if len(trees) == 1 else tree_stack(trees)


def per_replica(value: Any, update_batch: int) -> List[Any]:
    """One entry a replica of a value held once a replica (the step
    generator, a buffer state): the value itself at U = 1, else its tuple's."""
    return [value] if update_batch == 1 else list(value)


def join_per_replica(values: Sequence[Any]) -> Any:
    """The inverse of `per_replica`."""
    return values[0] if len(values) == 1 else tuple(values)


def mean_gradients(grads: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The replicas' gradient dicts averaged (the JAX package's pmean over
    "batch"); a single replica's as they are."""
    if len(grads) == 1:
        return grads[0]
    return {k: torch.stack([g[k] for g in grads]).mean(0) for k in grads[0]}


def make_step_generators(seed: int, device: torch.device, update_batch: int) -> Any:
    """The step generator, or a tuple of one a replica from independent seeds."""
    if update_batch == 1:
        return make_generator(seed, device)
    return tuple(make_generator(s, device) for s in make_seeds(seed, update_batch))


def env_group(tree: Any, index: int, update_batch: int, dim: int) -> Any:
    """Replica `index`'s env columns of every tensor (envs along `dim`)."""
    if update_batch == 1:
        return tree

    def cut(x: torch.Tensor) -> torch.Tensor:
        width = x.shape[dim] // update_batch
        return x.narrow(dim, index * width, width)

    return tree_map(cut, tree)
