"""The item-buffer facade over the sharded replay core (counterpart of
stoix_tpu/replay/compat.py): Anakin's `system.replay.impl: sharded`.

The off-policy family (systems/off_policy_core.py) talks to its buffer
through the item buffer's interface; this facade keeps that interface and
moves only the sampling semantics, from each rank's own uniform draw to the
GLOBAL draw of replay/core.py over the ranks of a `torch.distributed` group:
each rank is one shard, the core's local stages run on it, and between them

  - `add` writes the rank's items locally (uniform mode, no collective);
  - `sample` broadcasts rank 0's uniforms (the counterpart of the JAX
    package's `replicated_key`: the ranks' generators differ, since they
    drive env stepping), all-gathers the K scalar masses, and sums the
    owner-masked rows over the ranks;
  - `can_sample` sums the ranks' fills.

Always uniform: the interface has no set_priorities seam, so a prioritized
table would never be updated (off_policy_core refuses `replay.prioritized`
on this path; Sebulba ff_dqn is the prioritized consumer). With no group
(one process) every collective is the identity. NCCL reduces on the card;
any other backend (gloo) on host copies.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from stoix_tpu_torch.buffers.buffers import ItemBufferSample
from stoix_tpu_torch.replay.core import ShardedReplayState, make_sharded_replay
from stoix_tpu_torch.utils.tree import tree_map


class ShardedItemBuffer(NamedTuple):
    """The item buffer's interface over the sharded core, and the draws'
    seam (`sample_from_uniforms`, the global batch's uniforms)."""

    init: Callable[[Any], ShardedReplayState]
    add: Callable[[ShardedReplayState, Any], ShardedReplayState]
    sample: Callable[[ShardedReplayState, torch.Generator], ItemBufferSample]
    can_sample: Callable[[ShardedReplayState], bool]
    sample_from_uniforms: Callable[[ShardedReplayState, torch.Tensor], ItemBufferSample]


def _on_host(group: Any) -> bool:
    return dist.get_backend(group) != "nccl"


def _broadcast_from_first(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    if group is None:
        return x
    device = x.device
    buf = x.cpu() if _on_host(group) else x.clone()
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return buf.to(device)


def _all_gather_scalar(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    if group is None:
        return x.reshape(1)
    device = x.device
    local = x.reshape(1).cpu() if _on_host(group) else x.reshape(1)
    out = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, local, group=group)
    return torch.cat(out).to(device)


def _sum_over_ranks(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """The ranks' owner-masked tensor summed (a bool leaf OR-ed)."""
    if group is None:
        return x
    device, dtype = x.device, x.dtype
    buf = x.to(torch.uint8) if dtype == torch.bool else x.clone()
    if _on_host(group):
        buf = buf.cpu()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    buf = buf.to(device)
    return buf != 0 if dtype == torch.bool else buf


def make_sharded_item_buffer(capacity_per_shard: int, sample_batch_size: int, num_shards: int,
                             min_fill: int, group: Optional[Any] = None) -> ShardedItemBuffer:
    """`sample_batch_size` is GLOBAL; each rank receives its
    `sample_batch_size // num_shards` slice, sized so that its batch is the
    local impl's, only drawn fleet-wide. `group` is the data axis's process
    group (None for one process, where `num_shards` is 1)."""
    core = make_sharded_replay(capacity_per_shard, sample_batch_size, num_shards,
                               prioritized=False, min_fill=min_fill)
    shard = 0 if group is None else dist.get_rank(group)

    def add(state: ShardedReplayState, batch: Any) -> ShardedReplayState:
        return core.write(state, batch, core.new_priority(None))

    def sample_from_uniforms(state: ShardedReplayState, uniforms: torch.Tensor
                             ) -> ItemBufferSample:
        masses = _all_gather_scalar(core.mass(state), group)
        rows, probs, g_idx = core.draw(state, shard, masses, uniforms)
        rows = tree_map(lambda x: _sum_over_ranks(x, group), rows)
        return ItemBufferSample(core.take(shard, rows, probs, g_idx).experience)

    def sample(state: ShardedReplayState, generator: torch.Generator) -> ItemBufferSample:
        uniforms = torch.rand((sample_batch_size,), generator=generator, device=generator.device)
        return sample_from_uniforms(state, _broadcast_from_first(uniforms, group))

    def can_sample(state: ShardedReplayState) -> bool:
        filled = torch.tensor([core.filled(state)], dtype=torch.int64)
        if group is not None and not _on_host(group):
            filled = filled.to(state.priorities.device)
        return int(_sum_over_ranks(filled, group)[0]) >= core.min_fill

    return ShardedItemBuffer(core.init, add, sample, can_sample, sample_from_uniforms)
