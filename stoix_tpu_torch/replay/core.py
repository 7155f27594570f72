"""Per-shard functional core of the sharded replay service (counterpart of
stoix_tpu/replay/core.py).

Each data shard owns a ring of `capacity` items and a float32 priority a
slot (0 marks an unwritten slot). A draw of the GLOBAL batch costs

  1. a gather of the K scalar shard masses: every shard computes the same
     total and the same inclusive-prefix ownership bounds, so the global
     inverse CDF partitions [0, total) over the shards exactly (shard k owns
     u in [bounds[k-1], bounds[k]); the last shard also absorbs the
     floating-point top edge);
  2. a local prefix sum and `searchsorted(right)` a shard, the position
     clipped to the shard's WRITTEN prefix;
  3. a sum over the shards of the OWNER-MASKED rows, probabilities and
     global indices (each drawn row is owned by one shard, the others add
     zeros), after which shard k keeps its B/K slice of the batch.

Every op is split at its collective: a local stage, the gather or sum, then
a local stage. `ShardedReplayCore` holds the local stages and drives them
over a list of in-process shards (a Sebulba learner's devices,
replay/service.py); replay/compat.py drives the same stages over the ranks
of a `torch.distributed` group (Anakin's `replay.impl: sharded`). The draws
are an argument: `sample_from_uniforms` takes the B uniforms in [0, 1) that
the JAX package draws from its replicated key, and `sample` draws them from
a generator. On one shard the core equals `make_reference_replay`, the same
math with every collective removed, bitwise.

The order of every float32 sum is XLA's on the CPU, so the port and the JAX
package draw the same indices from the same priorities:

  - `xla_sum_f32`: XLA's tree reduction rewriter: the input padded with
    zeros to a multiple of 32 (SAME padding, half the zeros in front),
    each window of 32 summed in order, and again over the window sums until
    32 or fewer are left, which are summed in order;
  - `xla_cumsum_f32`: XLA's reduce-window rewriter for a cumulative sum:
    blocks of 16 (zero-padded at the end), an in-order prefix sum in each
    block, the block totals' own cumulative sum by the same rule, and the
    exclusive prefix of the totals added to every block.

Both are sequences of elementwise float32 adds, so they give the same bits
on the card and on the CPU. `torch.cumsum` does not: on the CPU it
accumulates float32 in float64. The priority exponent and the importance
weights' power are taken in float64 and rounded once (XLA's float32 `pow`
is a few ulps from either; the tests hold it at 1e-6 relative).

Ring bookkeeping (`insert_pos`, `num_added`) is host ints: every add's size
is known on the host, so no op here reads the device.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from stoix_tpu_torch.buffers.buffers import set_last_of_duplicates
from stoix_tpu_torch.utils.tree import tree_leaves, tree_map

SUM_WINDOW = 32  # XLA's tree reduction window on the CPU
CUMSUM_BLOCK = 16  # XLA's cumulative-sum block on the CPU


class ShardedReplayState(NamedTuple):
    """One shard's ring (leaves carry no shard axis)."""

    experience: Any  # tree of [capacity, ...] tensors, written in place
    priorities: torch.Tensor  # [capacity] float32; 0.0 marks an unwritten slot
    insert_pos: int  # next write slot in this shard's ring
    num_added: int  # items ever written to this shard


class ShardedSample(NamedTuple):
    """One shard's slice of one globally drawn batch."""

    experience: Any  # tree of [batch_per_shard, ...] tensors
    indices: torch.Tensor  # [batch_per_shard] int32: shard * capacity + slot
    probabilities: torch.Tensor  # [batch_per_shard] float32 under the GLOBAL draw


# ---------------------------------------------------------------- XLA's sum orders


def _add_in_order(columns: torch.Tensor) -> torch.Tensor:
    """Row sums of a [rows, n] tensor, each starting from 0 and adding its
    columns left to right (one elementwise add a column)."""
    acc = torch.zeros_like(columns[:, 0])
    for j in range(columns.shape[1]):
        acc = acc + columns[:, j]
    return acc


def xla_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """The sum of a float32 vector in XLA's CPU order (the module's note)."""
    x = x.reshape(1, -1)
    while x.shape[1] > SUM_WINDOW:
        n = x.shape[1]
        windows = -(-n // SUM_WINDOW)
        pad = windows * SUM_WINDOW - n
        x = _add_in_order(F.pad(x, (pad // 2, pad - pad // 2)).view(windows, SUM_WINDOW))
        x = x.reshape(1, -1)
    return _add_in_order(x)[0]


def xla_cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """The inclusive cumulative sum of a float32 vector in XLA's CPU order
    (the module's note)."""
    n = x.numel()
    blocks = -(-n // CUMSUM_BLOCK)
    within = F.pad(x.reshape(-1), (0, blocks * CUMSUM_BLOCK - n)).view(blocks, CUMSUM_BLOCK)
    within = within + 0.0  # a copy; 0 + x as XLA's window starts
    for j in range(1, CUMSUM_BLOCK):
        within[:, j] += within[:, j - 1]
    if blocks > 1:
        inclusive = xla_cumsum_f32(within[:, -1].contiguous())
        exclusive = F.pad(inclusive[:-1], (1, 0))
        within = within + exclusive[:, None]
    return within.reshape(-1)[:n]


def pow_f32(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """`x ** exponent` of a float32 tensor, taken in float64 and rounded once."""
    return torch.pow(x.double(), float(exponent)).float()


def _where_rows(mask: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Rows where `mask`, zeros elsewhere (any dtype)."""
    expanded = mask.reshape(mask.shape + (1,) * (rows.dim() - 1))
    return torch.where(expanded, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


def _init_state(item: Any, capacity: int) -> ShardedReplayState:
    experience = tree_map(lambda x: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                                                device=x.device), item)
    device = tree_leaves(experience)[0].device
    return ShardedReplayState(experience, torch.zeros(capacity, dtype=torch.float32,
                                                      device=device), 0, 0)


def _write(state: ShardedReplayState, batch: Any, new_priority: Any,
           capacity: int) -> ShardedReplayState:
    """`batch`'s items written in place at the ring's next slots, their
    priorities set to `new_priority`. A batch longer than the ring keeps its
    last `capacity` items, the ones a last-wins scatter leaves."""
    n = tree_leaves(batch)[0].shape[0]
    device = state.priorities.device
    idx = (state.insert_pos + torch.arange(n, device=device)) % capacity
    if n > capacity:
        idx = idx[-capacity:]
        batch = tree_map(lambda x: x[-capacity:], batch)
    tree_map(lambda buf, new: buf.index_copy_(0, idx, new.to(device=buf.device, dtype=buf.dtype)),
             state.experience, batch)
    if torch.is_tensor(new_priority):
        # index_fill_ would read a tensor value back to the host.
        state.priorities.index_copy_(0, idx, new_priority.expand(idx.numel()))
    else:
        state.priorities.index_fill_(0, idx, new_priority)
    return ShardedReplayState(state.experience, state.priorities,
                              (state.insert_pos + n) % capacity, state.num_added + n)


def _filled(state: ShardedReplayState, capacity: int) -> int:
    return min(state.num_added, capacity)


def _search_written(cdf: torch.Tensor, pos: torch.Tensor, filled: int) -> torch.Tensor:
    """`searchsorted(cdf, pos, right)` clipped into the written prefix: a
    float32 sliver at the top of a shard's range must land on a written
    slot, never on an unwritten zero row."""
    idx = torch.searchsorted(cdf, pos, right=True)
    return torch.clamp(idx, 0, max(filled - 1, 0))


def _scaled_priorities(priorities: torch.Tensor, exponent: float) -> torch.Tensor:
    return pow_f32(torch.abs(priorities) + 1e-6, exponent)


# ---------------------------------------------------------------- the sharded core


class ShardedReplayCore:
    """The per-shard stages of every op, and the loops that run them over a
    list of shard states (shard k's on the k-th device).

    `capacity` is a shard's; `sample_batch_size` is the GLOBAL batch, of
    which each shard receives `sample_batch_size // num_shards`."""

    def __init__(self, capacity: int, sample_batch_size: int, num_shards: int,
                 prioritized: bool = False, priority_exponent: float = 0.6,
                 min_fill: int = 1):
        if sample_batch_size % num_shards != 0:
            raise ValueError(
                f"sample_batch_size ({sample_batch_size}) must divide evenly over "
                f"{num_shards} shard(s) — every shard consumes an equal slice")
        self.capacity = int(capacity)
        self.sample_batch_size = int(sample_batch_size)
        self.num_shards = int(num_shards)
        self.batch_per_shard = self.sample_batch_size // self.num_shards
        self.prioritized = bool(prioritized)
        self.priority_exponent = float(priority_exponent)
        self.min_fill = int(min_fill)

    # -- local stages ------------------------------------------------------
    def init(self, item: Any) -> ShardedReplayState:
        """An empty ring for one unbatched `item`, on the item's device."""
        return _init_state(item, self.capacity)

    def local_max(self, state: ShardedReplayState) -> torch.Tensor:
        return torch.max(state.priorities)

    def new_priority(self, global_max: Optional[torch.Tensor]) -> Any:
        """New data samples at least once: the GLOBAL max priority (at least
        1) when prioritized, else 1.0, so the uniform draw covers every
        filled slot fleet-wide however unevenly the shards fill."""
        if not self.prioritized:
            return 1.0
        return torch.clamp_min(global_max, 1.0)

    def write(self, state: ShardedReplayState, batch: Any, new_priority: Any
              ) -> ShardedReplayState:
        return _write(state, batch, new_priority, self.capacity)

    def mass(self, state: ShardedReplayState) -> torch.Tensor:
        return xla_sum_f32(state.priorities)

    def draw(self, state: ShardedReplayState, shard: int, masses: torch.Tensor,
             uniforms: torch.Tensor) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        """Shard `shard`'s owner-masked [B] rows, probabilities and global
        indices for the GLOBAL draw `uniforms` [B], given every shard's mass
        [K] (identical on every shard)."""
        total = xla_sum_f32(masses)
        bounds = xla_cumsum_f32(masses)
        u = uniforms * total
        if shard == 0:
            lower = torch.zeros((), dtype=torch.float32, device=u.device)
        else:
            lower = bounds[shard - 1]
        owned = u >= lower
        if shard != self.num_shards - 1:
            owned = owned & (u < bounds[shard])
        pos = u - lower
        cdf = xla_cumsum_f32(state.priorities)
        idx = _search_written(cdf, pos, _filled(state, self.capacity))
        rows = tree_map(lambda buf: _where_rows(owned, buf.index_select(0, idx)),
                        state.experience)
        probs = torch.where(owned, state.priorities[idx] / torch.clamp_min(total, 1e-9), 0.0)
        g_idx = torch.where(owned, idx + shard * self.capacity, 0).to(torch.int32)
        return rows, probs, g_idx

    def take(self, shard: int, rows: Any, probs: torch.Tensor, g_idx: torch.Tensor
             ) -> ShardedSample:
        """Shard `shard`'s slice of the summed batch."""
        start = shard * self.batch_per_shard
        cut = slice(start, start + self.batch_per_shard)
        return ShardedSample(tree_map(lambda x: x[cut], rows), g_idx[cut], probs[cut])

    def scatter(self, state: ShardedReplayState, shard: int, all_indices: torch.Tensor,
                all_priorities: torch.Tensor) -> ShardedReplayState:
        """`(|p| + 1e-6) ** exponent` written to the slots of the gathered
        (global index, priority) pairs that this shard owns, in place; the
        last of duplicate indices wins."""
        all_indices = all_indices.reshape(-1).to(torch.int64)
        mine = torch.div(all_indices, self.capacity, rounding_mode="floor") == shard
        # Pairs of other shards write one slot past the end, which is dropped.
        slot = torch.where(mine, all_indices % self.capacity, self.capacity)
        values = _scaled_priorities(all_priorities.reshape(-1), self.priority_exponent)
        table = F.pad(state.priorities, (0, 1))
        set_last_of_duplicates(table, slot, values.to(table.dtype))
        state.priorities.copy_(table[:self.capacity])
        return state

    def filled(self, state: ShardedReplayState) -> int:
        return _filled(state, self.capacity)

    # -- the stages over in-process shards ---------------------------------
    def add(self, states: List[ShardedReplayState], batches: Sequence[Any]
            ) -> List[ShardedReplayState]:
        """Each shard's batch written to its ring; every new slot's priority
        from the max over all shards BEFORE the writes."""
        global_max = None
        if self.prioritized:
            home = states[0].priorities.device
            global_max = torch.max(torch.stack([self.local_max(s).to(home) for s in states]))
        new = self.new_priority(global_max)
        return [self.write(s, b, new if not torch.is_tensor(new)
                           else new.to(s.priorities.device))
                for s, b in zip(states, batches)]

    def sample_from_uniforms(self, states: List[ShardedReplayState], uniforms: torch.Tensor
                             ) -> List[ShardedSample]:
        """The GLOBAL draw of `uniforms` [B] in [0, 1): each shard's slice."""
        masses = [self.mass(s) for s in states]
        parts = []
        for k, s in enumerate(states):
            device = s.priorities.device
            parts.append(self.draw(s, k, torch.stack([m.to(device) for m in masses]),
                                   uniforms.to(device)))
        samples = []
        for k, s in enumerate(states):
            device = s.priorities.device
            summed = [sum_over_shards([p[i] for p in parts], device) for i in range(3)]
            samples.append(self.take(k, *summed))
        return samples

    def sample(self, states: List[ShardedReplayState], generator: torch.Generator
               ) -> List[ShardedSample]:
        uniforms = torch.rand((self.sample_batch_size,), generator=generator,
                              device=generator.device)
        return self.sample_from_uniforms(states, uniforms)

    def set_priorities(self, states: List[ShardedReplayState],
                       indices: Sequence[torch.Tensor], priorities: Sequence[torch.Tensor]
                       ) -> List[ShardedReplayState]:
        """Each shard's (global index, priority) pairs gathered in shard
        order, then scattered to their owners."""
        out = []
        for k, s in enumerate(states):
            device = s.priorities.device
            all_idx = torch.cat([i.reshape(-1).to(device) for i in indices])
            all_p = torch.cat([p.reshape(-1).to(device) for p in priorities])
            out.append(self.scatter(s, k, all_idx, all_p))
        return out

    def can_sample(self, states: List[ShardedReplayState]) -> bool:
        return sum(self.filled(s) for s in states) >= self.min_fill

    def occupancy(self, states: List[ShardedReplayState]) -> List[int]:
        return [self.filled(s) for s in states]


def sum_over_shards(parts: Sequence[Any], device: torch.device) -> Any:
    """The shards' owner-masked trees summed on `device` (the JAX package's
    psum): every row has one owner and zeros elsewhere, so any order gives
    the same bits; a bool leaf is the OR of its shards'."""
    def add(*leaves):
        leaves = [x.to(device) for x in leaves]
        if len(leaves) == 1:
            return leaves[0]
        if leaves[0].dtype == torch.bool:
            return torch.stack(leaves).any(dim=0)
        total = leaves[0]
        for x in leaves[1:]:
            total = total + x
        return total

    return tree_map(add, *parts)


def make_sharded_replay(capacity: int, sample_batch_size: int, num_shards: int,
                        prioritized: bool = False, priority_exponent: float = 0.6,
                        min_fill: int = 1) -> ShardedReplayCore:
    """The per-shard core: `capacity` a shard's, `sample_batch_size` global."""
    return ShardedReplayCore(capacity, sample_batch_size, num_shards, prioritized,
                             priority_exponent, min_fill)


# ---------------------------------------------------------------- the reference


class ReferenceReplay:
    """The single-device reference sampler: the same math with every
    collective removed. The sharded core on one shard equals it bitwise
    (tests/test_torch_replay.py), as in the JAX package."""

    def __init__(self, capacity: int, sample_batch_size: int, prioritized: bool = False,
                 priority_exponent: float = 0.6, min_fill: int = 1):
        self.capacity = int(capacity)
        self.sample_batch_size = int(sample_batch_size)
        self.prioritized = bool(prioritized)
        self.priority_exponent = float(priority_exponent)
        self.min_fill = int(min_fill)

    def init(self, item: Any) -> ShardedReplayState:
        return _init_state(item, self.capacity)

    def add(self, state: ShardedReplayState, batch: Any) -> ShardedReplayState:
        new = torch.clamp_min(torch.max(state.priorities), 1.0) if self.prioritized else 1.0
        return _write(state, batch, new, self.capacity)

    def sample_from_uniforms(self, state: ShardedReplayState, uniforms: torch.Tensor
                             ) -> ShardedSample:
        total = xla_sum_f32(xla_sum_f32(state.priorities)[None])
        u = uniforms * total
        cdf = xla_cumsum_f32(state.priorities)
        idx = _search_written(cdf, u, _filled(state, self.capacity))
        rows = tree_map(lambda buf: buf.index_select(0, idx), state.experience)
        probs = state.priorities[idx] / torch.clamp_min(total, 1e-9)
        return ShardedSample(rows, idx.to(torch.int32), probs)

    def sample(self, state: ShardedReplayState, generator: torch.Generator) -> ShardedSample:
        uniforms = torch.rand((self.sample_batch_size,), generator=generator,
                              device=generator.device)
        return self.sample_from_uniforms(state, uniforms)

    def set_priorities(self, state: ShardedReplayState, indices: torch.Tensor,
                       priorities: torch.Tensor) -> ShardedReplayState:
        values = _scaled_priorities(priorities.reshape(-1), self.priority_exponent)
        set_last_of_duplicates(state.priorities, indices.reshape(-1).to(torch.int64), values)
        return state

    def can_sample(self, state: ShardedReplayState) -> bool:
        return _filled(state, self.capacity) >= self.min_fill

    def occupancy(self, state: ShardedReplayState) -> int:
        return _filled(state, self.capacity)


def make_reference_replay(capacity: int, sample_batch_size: int, prioritized: bool = False,
                          priority_exponent: float = 0.6, min_fill: int = 1) -> ReferenceReplay:
    return ReferenceReplay(capacity, sample_batch_size, prioritized, priority_exponent, min_fill)
