"""Welford running mean and std for observation normalisation (counterpart
of stoix_tpu/ops/running_statistics.py).

The JAX package's `update` psums counts and sums over named axes (the
update-batch vmap and the mesh) so that every replica holds the same
statistics. Here the replicas are an axis of the batch itself:
`replica_axis` names it, each replica's sums are taken first and then summed
over the replicas, in the psum's order, and one set of statistics comes out.
The mesh's "data" axis is a process group: with `group`, those sums are then
summed over its ranks (two all-reduces, since the second sum needs the new
mean), as the JAX package's `axis_names=("batch", "data")` sums them.
Statistics are trees shaped like the observation (a tensor, or NamedTuples,
dicts, lists of tensors), float32.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from stoix_tpu_torch.utils.tree import tree_leaves, tree_map


class RunningStatisticsState(NamedTuple):
    count: torch.Tensor  # scalar float32: elements folded in, over every replica
    mean: Any  # a tree like the observation
    summed_variance: Any
    std: Any


def init_state(template: Any) -> RunningStatisticsState:
    """Zeroed statistics shaped like `template` (one observation, no batch
    axis), on its device."""
    zeros = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), template)
    ones = tree_map(lambda x: torch.ones(x.shape, dtype=torch.float32, device=x.device), template)
    count = torch.zeros((), dtype=torch.float32, device=tree_leaves(zeros)[0].device)
    return RunningStatisticsState(count=count, mean=zeros, summed_variance=zeros, std=ones)


def _sum(x: torch.Tensor, feature_ndim: int, replica_axis: Optional[int]) -> torch.Tensor:
    """Sum over every leading axis; with a replica axis, within each replica
    first and then over the replicas."""
    lead = x.ndim - feature_ndim
    if replica_axis is None:
        return x.sum(dim=tuple(range(lead))) if lead else x
    within = tuple(d for d in range(lead) if d != replica_axis)
    per_replica = x.sum(dim=within) if within else x
    return per_replica.sum(dim=0)


def update(
    state: RunningStatisticsState,
    batch: Any,
    *,
    replica_axis: Optional[int] = None,
    group: Optional[dist.ProcessGroup] = None,
    std_min_value: float = 1e-6,
    std_max_value: float = 1e6,
) -> RunningStatisticsState:
    """Fold a batch of observations into the statistics. Leaves are
    [leading..., *feature_shape]; every leading axis is reduced. With
    `replica_axis` (a leading axis holding the update-batch replicas), each
    replica's sums are taken first and then summed, as the JAX package's psum
    over the "batch" axis sums them; with `group` (the "data" axis), the
    count and sums are then summed over its ranks."""
    from stoix_tpu_torch.systems.anakin import data_sum

    feature_ndim = tree_leaves(state.mean)[0].ndim
    leaf = tree_leaves(batch)[0]
    lead_shape = leaf.shape[: leaf.ndim - feature_ndim]
    batch_count = 1
    for size in lead_shape:
        batch_count *= int(size)
    diff_sums = tree_map(lambda mean, b: _sum(b - mean, mean.ndim, replica_axis),
                         state.mean, batch)
    if group is None:
        new_count = state.count + float(batch_count)
    else:
        count = torch.tensor(float(batch_count), device=state.count.device)
        count, diff_sums = data_sum((count, diff_sums), group)
        new_count = state.count + count

    means = tree_map(lambda mean, diff: mean + diff / new_count, state.mean, diff_sums)
    squares = tree_map(lambda mean, mean_new, b: _sum((b - mean) * (b - mean_new), mean.ndim,
                                                      replica_axis),
                       state.mean, means, batch)
    squares = data_sum(squares, group)
    summed = tree_map(lambda svar, square: svar + square, state.summed_variance, squares)
    stds = tree_map(
        lambda svar: torch.clamp(torch.sqrt(svar / new_count), std_min_value, std_max_value),
        summed,
    )
    return RunningStatisticsState(count=new_count, mean=means, summed_variance=summed, std=stds)


def normalize(batch: Any, state: RunningStatisticsState,
              max_abs_value: Optional[float] = None) -> Any:
    def norm(b: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
        out = (b - mean) / std
        if max_abs_value is not None:
            out = torch.clamp(out, -max_abs_value, max_abs_value)
        return out

    return tree_map(norm, batch, state.mean, state.std)


def denormalize(batch: Any, state: RunningStatisticsState) -> Any:
    return tree_map(lambda b, mean, std: b * std + mean, batch, state.mean, state.std)


def clip(batch: Any, max_abs_value: float) -> Any:
    return tree_map(lambda b: torch.clamp(b, -max_abs_value, max_abs_value), batch)


def normalize_observation(
    observation: Any, state: RunningStatisticsState, max_abs_value: float = 10.0
) -> Any:
    """An Observation with its agent_view normalised (and clipped to
    `max_abs_value`), its other fields as they are."""
    return observation._replace(
        agent_view=normalize(observation.agent_view, state, max_abs_value=max_abs_value)
    )
