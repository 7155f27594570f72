"""The sharded replay service over a Sebulba learner's devices (counterpart of
stoix_tpu/replay/service.py).

`ShardedReplayService` holds one ring a learner device (shard k's on the
k-th device) and drives the core's in-process stages over them
(replay/core.py):

  add(shards)          one batch a learner device, each already on its
                       device (the actors split their chunks over the
                       learner devices), so raw experience lands on its
                       shard and never moves again; the port's counterpart
                       of the JAX package's `assemble_global_array`
  sample(...)          the global draw; each shard's slice on its device
  set_priorities(...)  new priorities through global flat indices
  can_sample()         the summed fill >= min_fill, from host counts

A system that embeds the core's ops in its own learn step (Sebulba ff_dqn)
reads `state`, threads it through, hands it back with `commit`, and
accounts its draws with `note_embedded_samples`.

The service meters itself into the registry (`stoix_tpu_replay_*`): add and
sample op and item counters, the bytes ingested against the bytes of the
sampled minibatches that the cross-shard sum reconstructs (sizes from the
shapes: nothing reads the device on the hot path), and occupancy and
per-shard priority-mass gauges refreshed by `observe`, off the hot path.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from stoix_tpu_torch.observability import get_registry
from stoix_tpu_torch.replay.core import ShardedReplayState, ShardedSample, make_sharded_replay
from stoix_tpu_torch.utils.tree import tree_leaves, tree_map


def tree_bytes(tree: Any) -> int:
    """Byte size of a tree of tensors, from their shapes (no device read)."""
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


class ShardedReplayService:
    """Sharded replay over `devices`, one shard each. `item` is one
    unbatched transition (its leaves' shapes and dtypes); every shard rings
    `capacity_per_shard` items; `sample_batch_size` is the GLOBAL batch a
    sample draws."""

    def __init__(self, devices: Sequence[Any], item: Any, *, capacity_per_shard: int,
                 sample_batch_size: int, prioritized: bool = False,
                 priority_exponent: float = 0.6, min_fill: int = 1):
        self.devices = [torch.device(d) for d in devices]
        self.num_shards = len(self.devices)
        self.capacity_per_shard = int(capacity_per_shard)
        self.sample_batch_size = int(sample_batch_size)
        self.prioritized = bool(prioritized)
        self.core = make_sharded_replay(self.capacity_per_shard, self.sample_batch_size,
                                        self.num_shards, self.prioritized, priority_exponent,
                                        min_fill)
        self._state: List[ShardedReplayState] = [
            self.core.init(tree_map(lambda x, d=d: x.to(d), item)) for d in self.devices]

        registry = get_registry()
        self._add_ops = registry.counter("stoix_tpu_replay_add_ops_total",
                                         "Replay add programs executed")
        self._add_items = registry.counter("stoix_tpu_replay_add_items_total",
                                           "Transitions ingested into replay")
        self._ingested_bytes = registry.counter(
            "stoix_tpu_replay_ingested_bytes_total",
            "Raw experience bytes ingested (these bytes never cross shards)")
        self._sample_ops = registry.counter("stoix_tpu_replay_sample_ops_total",
                                            "Replay sample programs executed")
        self._sample_items = registry.counter("stoix_tpu_replay_sample_items_total",
                                              "Transitions drawn from replay")
        self._sampled_bytes = registry.counter(
            "stoix_tpu_replay_sampled_bytes_crossed_total",
            "Logical bytes of sampled minibatches (+ indices/probabilities) "
            "reconstructed across shards by the sample sum")
        self._occupancy_gauge = registry.gauge("stoix_tpu_replay_occupancy",
                                               "Items currently held, per shard")
        self._mass_gauge = registry.gauge("stoix_tpu_replay_priority_mass",
                                          "Total sampling mass, per shard")

    # -- state ownership -----------------------------------------------------
    @property
    def state(self) -> List[ShardedReplayState]:
        """The live shard states, one a learner device."""
        return self._state

    def commit(self, new_state: List[ShardedReplayState]) -> None:
        self._state = list(new_state)

    # -- ops -----------------------------------------------------------------
    def add(self, shards: Sequence[Any]) -> None:
        """Ingest one batch a learner device (leading item axis)."""
        if len(shards) != self.num_shards:
            raise ValueError(f"add takes one batch a shard ({self.num_shards}), "
                             f"got {len(shards)}")
        self._state = self.core.add(self._state, shards)
        self._add_ops.inc()
        self._add_items.inc(sum(tree_leaves(s)[0].shape[0] for s in shards))
        self._ingested_bytes.inc(sum(tree_bytes(s) for s in shards))

    def sample(self, generator: Optional[torch.Generator] = None,
               uniforms: Optional[torch.Tensor] = None) -> List[ShardedSample]:
        """The global draw, from `uniforms` [B] in [0, 1) when given, else
        from `generator`: each shard's slice on its device."""
        if uniforms is None:
            out = self.core.sample(self._state, generator)
        else:
            out = self.core.sample_from_uniforms(self._state, uniforms)
        self.note_embedded_samples(1)
        return out

    def note_embedded_samples(self, ops: int = 1) -> None:
        """Account draws made by the core's sample embedded in a system's
        own learn step (Sebulba ff_dqn), which bypasses `sample`."""
        self._sample_ops.inc(ops)
        self._sample_items.inc(ops * self.sample_batch_size)
        self._sampled_bytes.inc(ops * self.sample_bytes_crossed)

    def set_priorities(self, indices: Sequence[torch.Tensor],
                       priorities: Sequence[torch.Tensor]) -> None:
        self._state = self.core.set_priorities(self._state, indices, priorities)

    def can_sample(self) -> bool:
        return self.core.can_sample(self._state)

    # -- accounting ----------------------------------------------------------
    @property
    def sample_bytes_crossed(self) -> int:
        """Logical cross-shard payload of ONE sample: the global batch's rows
        plus an int32 index and a float32 probability each."""
        row_bytes = sum(x[0].numel() * x.element_size()
                        for x in tree_leaves(self._state[0].experience))
        return self.sample_batch_size * (int(row_bytes) + 8)

    def ring_bytes(self) -> int:
        """Device bytes of every shard's ring: experience and priorities."""
        return sum(tree_bytes(s.experience) + tree_bytes(s.priorities) for s in self._state)

    def observe(self) -> dict:
        """Off-hot-path telemetry: each shard's occupancy and priority mass
        (reads the device), published as per-shard gauges."""
        occupancy = self.core.occupancy(self._state)
        mass = [float(self.core.mass(s)) for s in self._state]
        for shard in range(self.num_shards):
            labels = {"shard": str(shard)}
            self._occupancy_gauge.set(float(occupancy[shard]), labels)
            self._mass_gauge.set(mass[shard], labels)
        return {"occupancy": occupancy, "priority_mass": mass}

    def stats(self) -> dict:
        """The cumulative transport ledger."""
        return {
            "add_ops": int(self._add_ops.value()),
            "added_items": int(self._add_items.value()),
            "ingested_bytes_total": int(self._ingested_bytes.value()),
            "sample_ops": int(self._sample_ops.value()),
            "sampled_items": int(self._sample_items.value()),
            "sampled_bytes_crossed": int(self._sampled_bytes.value()),
        }


def service_from_config(devices: Sequence[Any], item: Any, config: Any
                        ) -> Optional[ShardedReplayService]:
    """A service from `system.replay` and the global buffer and batch
    totals, None when `replay.impl` is not `sharded`: capacity
    `total_buffer_size // K` a shard, the batch global, and
    `min_fill = max(1, replay.min_fill or batch)`."""
    replay_cfg = dict(config.system.get("replay") or {})
    if str(replay_cfg.get("impl", "local")) != "sharded":
        return None
    shards = len(devices)
    capacity = max(1, int(config.system.total_buffer_size) // shards)
    batch = int(config.system.total_batch_size)
    min_fill = replay_cfg.get("min_fill")
    return ShardedReplayService(
        devices, item, capacity_per_shard=capacity, sample_batch_size=batch,
        prioritized=bool(replay_cfg.get("prioritized", False)),
        priority_exponent=float(replay_cfg.get("priority_exponent", 0.6)),
        min_fill=max(1, int(batch if min_fill in (None, "~") else min_fill)))
