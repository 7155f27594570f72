"""Anakin learner-construction helpers shared by system files (counterpart of
stoix_tpu/systems/anakin.py: `head_kwargs_for_env`, `reset_envs_for_anakin`,
`broadcast_to_update_batch` and `make_step_keys`, plus the seeding the JAX
package does with `jax.random.split`, the replica loop that stands in for its
`vmap(axis_name="batch")` over `arch.update_batch_size`, and the collectives
over the mesh's "data" axis that its learners run under `shard_map`).

Data parallelism: one process a card, one shard a process. The "data" axis
is every rank of the default process group, so a rank holds what a JAX
shard holds: its own `total_num_envs // N` envs, generators, trajectory and
buffer, and a replicated copy of params, optimizer states, observation
statistics and β. Nothing is placed; the learners call `data_mean` and
`data_sum` where the JAX learners call `pmean` and `psum` over "data". With
no process group both return their input untouched, so one process runs
exactly the ops it ran before data parallelism was ported.

Gossip groups (parallel/gossip.py): on a ("group", "data") mesh, which the
runner hands over with `use_mesh`, the "data" axis is the calling rank's
group's data subgroup, so every data collective, seed split and episode
share stays inside the group, as shard_map scopes the JAX learner's pmean
over "data" to its group. A population's ("pop", "data") mesh
(population/runner.py) scopes the data axis the same way: each rank of the
"pop" axis holds its own members, trained on its pop group's data subgroup.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from stoix_tpu_torch import envs
from stoix_tpu_torch.envs import spaces as env_spaces
from stoix_tpu_torch.observability import get_registry
from stoix_tpu_torch.utils.config import _import_target
from stoix_tpu_torch.utils.tree import tree_leaves, tree_map, tree_stack

ALLREDUCE_COUNTER = "stoix_tpu_data_allreduces_total"


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


def torso_input_kwargs(torso_cfg: Any, example: torch.Tensor) -> dict:
    """The input size a torso config's module takes, from one env's input
    `example` (what the input layer makes of the observation): the conv
    torsos (an `input_shape` parameter) its whole shape, the MLP torsos
    (`input_dim`) its last dimension."""
    params = inspect.signature(_import_target(torso_cfg["_target_"])).parameters
    if "input_shape" in params:
        return {"input_shape": tuple(int(s) for s in example.shape)}
    return {"input_dim": int(example.shape[-1])}


def make_seeds(seed: int, count: int) -> List[int]:
    """`count` independent 63-bit seeds derived from one run seed (the
    port's `jax.random.split`)."""
    children = np.random.SeedSequence(int(seed)).spawn(count)
    return [int(c.generate_state(1, np.uint64)[0] >> np.uint64(1)) for c in children]


def group_member_seed(seed: int, group: int) -> int:
    """The seed of learner group `group`'s env and step streams: the run
    seed itself for group 0 (so one group is the plain run), else the first
    63-bit word of `np.random.SeedSequence([seed, group])` (the port's
    `fold_in(key, group)`)."""
    if group == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(group)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    return generator


# ---------------------------------------------------------------- the data axis


# The grouped mesh of the run in progress (None: the "data" axis is the
# default group). Set by the runner around a run with a "group" or a "pop"
# axis.
_GROUPED_MESH: Optional[DeviceMesh] = None
_OUTER_AXES = ("group", "pop")


@contextlib.contextmanager
def use_mesh(mesh: Optional[DeviceMesh]):
    """Within the block, the data axis of `mesh` when it has a "group" or a
    "pop" axis (the calling rank's group's data subgroup); any other mesh
    changes nothing."""
    global _GROUPED_MESH
    grouped = mesh is not None and any(a in (mesh.mesh_dim_names or ()) for a in _OUTER_AXES)
    previous = _GROUPED_MESH
    _GROUPED_MESH = mesh if grouped else None
    try:
        yield
    finally:
        _GROUPED_MESH = previous


def data_group() -> Optional[dist.ProcessGroup]:
    """The process group of the mesh's "data" axis: the calling rank's
    group's data subgroup on a grouped mesh, else the default group when one
    is initialised, else None (a single process)."""
    if _GROUPED_MESH is not None:
        return _GROUPED_MESH.get_group("data")
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def _outer(axis: str) -> Optional[DeviceMesh]:
    names = () if _GROUPED_MESH is None else (_GROUPED_MESH.mesh_dim_names or ())
    return _GROUPED_MESH if axis in names else None


def grouped_mesh() -> Optional[DeviceMesh]:
    """The gossip groups' mesh of the run in progress, or None."""
    return _outer("group")


def group_rank_and_size() -> Tuple[int, int]:
    """(this rank's learner group, the number of groups): (0, 1) off a
    grouped mesh."""
    mesh = _outer("group")
    if mesh is None:
        return 0, 1
    group = mesh.get_group("group")
    return dist.get_rank(group), dist.get_world_size(group)


def pop_mesh() -> Optional[DeviceMesh]:
    """The population's ("pop", "data") mesh of the run in progress, or None."""
    return _outer("pop")


def pop_group() -> Optional[dist.ProcessGroup]:
    """The process group of the run's "pop" axis (the ranks that hold the
    other members beside this rank's data index), or None off a pop mesh."""
    mesh = _outer("pop")
    return None if mesh is None else mesh.get_group("pop")


def pop_rank_and_size() -> Tuple[int, int]:
    """(this rank's index on the "pop" axis, the axis size): (0, 1) off a pop mesh."""
    group = pop_group()
    return (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))


def data_rank_and_size() -> Tuple[int, int]:
    """(this rank's index on the "data" axis, the axis size): (0, 1) with no group."""
    group = data_group()
    return (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))


def rank_seed(seed: int) -> int:
    """This rank's seed of a per-shard stream: the r-th of N seeds split from
    `seed` on N ranks, and `seed` itself on one (so one process draws the
    stream it always drew)."""
    rank, size = data_rank_and_size()
    return int(seed) if size == 1 else make_seeds(seed, size)[rank]


def allreduce_counter():
    return get_registry().counter(
        ALLREDUCE_COUNTER, "All-reduces over the mesh's data axis, by what they reduce (kind)")


def _all_reduce_sum(tree: Any, group: dist.ProcessGroup, kind: str) -> Any:
    """`tree` summed over `group`: its tensor leaves flattened into one bucket
    a dtype, one SUM all-reduce each. NCCL reduces on the card; any other
    backend (gloo) on host copies."""
    leaves = tree_leaves(tree)
    out: List[torch.Tensor] = list(leaves)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    on_host = dist.get_backend(group) != "nccl"
    for index in by_dtype.values():
        bucket = torch.cat([leaves[i].reshape(-1) for i in index])
        device = bucket.device
        if on_host:
            bucket = bucket.cpu()
        dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=group)
        allreduce_counter().inc(labels={"kind": kind})
        parts = bucket.to(device).split([leaves[i].numel() for i in index])
        for i, part in zip(index, parts):
            out[i] = part.view(leaves[i].shape)
    rebuilt = iter(out)
    return tree_map(lambda _: next(rebuilt), tree)


def data_sum(tree: Any, group: Optional[dist.ProcessGroup], kind: str = "statistics") -> Any:
    """The JAX package's psum over "data": `tree`'s tensor leaves summed over
    the ranks, in one all-reduce a dtype; `tree` itself with no group."""
    return tree if group is None else _all_reduce_sum(tree, group, kind)


def data_mean(tree: Any, group: Optional[dist.ProcessGroup], kind: str = "gradients") -> Any:
    """The JAX package's pmean over "data": the sum over the ranks divided by
    their count, in one all-reduce a dtype (a gradient dict, several of
    them, or a scalar); `tree` itself with no group."""
    if group is None:
        return tree
    size = dist.get_world_size(group)
    return tree_map(lambda x: x / size, _all_reduce_sum(tree, group, kind))


def reset_envs_for_anakin(
    env: envs.Environment, config: Any, generator: torch.Generator
) -> Tuple[Any, Any]:
    """Reset this rank's `arch.total_num_envs // N` envs (all of them in one
    process) on the generator's device; the caller seeds the generator with
    `rank_seed`. Under `arch.update_batch_size` U they are U groups along the
    env axis, replica u's the u-th."""
    return env.reset(generator, int(config.arch.total_num_envs) // data_rank_and_size()[1])


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
    """The step generator, or a tuple of one a replica (the JAX package's
    `make_step_keys`, [N, U] keys): rank r's U generators are the r-th U of
    N·U seeds split from `seed`. One process with one replica draws from
    `seed` itself."""
    rank, size = data_rank_and_size()
    if size * update_batch == 1:
        return make_generator(seed, device)
    seeds = make_seeds(seed, size * update_batch)[rank * update_batch:(rank + 1) * update_batch]
    if update_batch == 1:
        return make_generator(seeds[0], device)
    return tuple(make_generator(s, device) for s in seeds)


def env_group(tree: Any, index: int, update_batch: int, dim: int) -> Any:
    """Replica `index`'s env columns of every tensor (envs along `dim`)."""
    if update_batch == 1:
        return tree

    def cut(x: torch.Tensor) -> torch.Tensor:
        width = x.shape[dim] // update_batch
        return x.narrow(dim, index * width, width)

    return tree_map(cut, tree)
