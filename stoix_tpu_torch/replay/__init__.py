"""Sharded replay (counterpart of stoix_tpu/replay): ring state sharded over
the learner devices or the data ranks, the prioritized or uniform GLOBAL
draw taken where the data lives, so only sampled minibatches cross shards.
`replay.core` holds the per-shard stages and runs them over in-process shards,
`replay.service` the Sebulba off-policy service, `replay.compat` the item
buffer facade over a process group (Anakin's `replay.impl: sharded`)."""

from stoix_tpu_torch.replay.core import (
    ReferenceReplay,
    ShardedReplayCore,
    ShardedReplayState,
    ShardedSample,
    make_reference_replay,
    make_sharded_replay,
    xla_cumsum_f32,
    xla_sum_f32,
)
from stoix_tpu_torch.replay.service import ShardedReplayService, service_from_config, tree_bytes

__all__ = [
    "ReferenceReplay", "ShardedReplayCore", "ShardedReplayService", "ShardedReplayState",
    "ShardedSample", "make_reference_replay", "make_sharded_replay", "service_from_config",
    "tree_bytes", "xla_cumsum_f32", "xla_sum_f32",
]
