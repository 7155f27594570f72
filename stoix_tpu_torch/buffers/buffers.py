"""On-device replay buffers (counterpart of stoix_tpu/buffers/buffers.py: the
flashbax item, trajectory and prioritised trajectory buffers the JAX
package's off-policy systems replay from).

Every buffer lives on the device: `init` preallocates one tensor for every
leaf of an item tree (zeros, as the JAX package's), and `add` writes into
those tensors IN PLACE (`index_copy_`), since they are the buffer's one copy
of the experience (the JAX package returns new arrays); the state it returns
shares them. Experience is any nested tuple, NamedTuple or dict of tensors
(rec_r2d2 stores an LSTM carry `(c, h)`).

`insert_pos` and `num_added` are host ints. The Anakin fill is
deterministic (warmup steps, then the rollout's steps an update), so the
host knows both without reading the device; every bound a sampler draws
from, and `can_sample`, is computed on the host. Nothing here synchronises
with the device.

Each sampler takes an explicit `torch.Generator` and has a seam that takes
the draws themselves (`gather`, `sample_from`, `sample_from_uniforms`), so a
test can feed the port the indices or uniforms JAX drew.

- Item buffer: `[capacity, ...]` leaves, uniform sampling of written items.
- Trajectory buffer: `[add_batch, time_capacity, ...]` leaves, a batch of
  `[add_batch, t_chunk, ...]` written at `insert_pos` with wraparound;
  sequences of `sample_sequence_length` contiguous steps start on a
  `period` stride and never cross the write head once the buffer has
  wrapped (`_valid_starts`).
- Prioritised trajectory buffer: the same, with one float32 priority a
  sequence-start SLOT (`time_capacity // period` slots a row). New slots
  get the largest priority so far (at least 1); sampling is an inverse CDF
  over the flattened table (mask, flatten, cumsum, u x total, searchsorted
  on the right, clip, probabilities / max(total, 1e-9)); everything stays in
  PHYSICAL slot space, so priorities, data and returned indices name the same
  slots after a wrap. `set_priorities` keeps the LAST of duplicate indices,
  as `.at[].set` does in JAX on the CPU, and deterministically on the card
  (see `set_priorities`).

The debug sample guard (`STOIX_TPU_BUFFER_DEBUG`, `set_sample_guard`) raises
`EmptyBufferSampleError` when a buffer samples before `can_sample`; it is off
by default, and then an unfilled buffer silently returns zero-initialised
items, as the JAX package's does (`systems/off_policy_core.py::
require_first_add_samplable` guards the warmup-less learners statically).
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple, Tuple

import torch

from stoix_tpu_torch.utils.tree import tree_leaves, tree_map


class EmptyBufferSampleError(RuntimeError):
    """A buffer sampled before it could: `can_sample` is False, so the batch
    would be zero-initialised items or sequences."""


_SAMPLE_GUARD = os.environ.get("STOIX_TPU_BUFFER_DEBUG", "") not in ("", "0")


def set_sample_guard(enabled: bool) -> bool:
    """Arm or disarm the debug sample guard (also armed by
    STOIX_TPU_BUFFER_DEBUG=1 at import); returns the previous setting."""
    global _SAMPLE_GUARD
    previous = _SAMPLE_GUARD
    _SAMPLE_GUARD = bool(enabled)
    return previous


def _guard_sample(ok: bool, what: str) -> None:
    """Debug-only can_sample enforcement; nothing unless armed."""
    if _SAMPLE_GUARD and not ok:
        raise EmptyBufferSampleError(
            f"EmptyBufferSampleError: sample() on an unfilled {what} — can_sample() is "
            "False, the returned batch would be zero-initialized garbage (guard armed by "
            "STOIX_TPU_BUFFER_DEBUG / buffers.set_sample_guard)"
        )


def _device_of(tree: Any) -> torch.device:
    return tree_leaves(tree)[0].device


# ---------------------------------------------------------------- item buffer


class ItemBufferState(NamedTuple):
    experience: Any  # tree of [capacity, ...] tensors
    insert_pos: int  # next write slot
    num_added: int  # items ever added


class ItemBufferSample(NamedTuple):
    experience: Any  # tree of [batch, ...] tensors


class ItemBuffer(NamedTuple):
    """Uniform flat-transition buffer (fbx.make_item_buffer's counterpart)."""

    init: Callable[[Any], ItemBufferState]
    add: Callable[[ItemBufferState, Any], ItemBufferState]
    sample: Callable[[ItemBufferState, torch.Generator], ItemBufferSample]
    can_sample: Callable[[ItemBufferState], bool]
    sample_indices: Callable[[ItemBufferState, torch.Generator], torch.Tensor]
    gather: Callable[[ItemBufferState, torch.Tensor], ItemBufferSample]


def make_item_buffer(max_length: int, min_length: int, sample_batch_size: int) -> ItemBuffer:
    """Items are added in batches of any size (one item per env per step).
    The JAX package's `add_batch_size` is nominal there (its add reads the
    batch's size) and is not taken here."""

    def init(item: Any) -> ItemBufferState:
        experience = tree_map(
            lambda x: torch.zeros((max_length,) + tuple(x.shape), dtype=x.dtype,
                                  device=x.device), item)
        return ItemBufferState(experience, 0, 0)

    def add(state: ItemBufferState, batch: Any) -> ItemBufferState:
        n = tree_leaves(batch)[0].shape[0]
        idx = (state.insert_pos + torch.arange(n, device=_device_of(state.experience))) % max_length
        tree_map(lambda buf, new: buf.index_copy_(0, idx, new.to(buf.dtype)),
                 state.experience, batch)
        return ItemBufferState(state.experience, (state.insert_pos + n) % max_length,
                               state.num_added + n)

    def sample_indices(state: ItemBufferState, generator: torch.Generator) -> torch.Tensor:
        current_size = min(state.num_added, max_length)
        return torch.randint(0, max(current_size, 1), (sample_batch_size,),
                             generator=generator, device=generator.device)

    def gather(state: ItemBufferState, indices: torch.Tensor) -> ItemBufferSample:
        return ItemBufferSample(tree_map(lambda buf: buf.index_select(0, indices),
                                         state.experience))

    def sample(state: ItemBufferState, generator: torch.Generator) -> ItemBufferSample:
        _guard_sample(can_sample(state), "item buffer")
        return gather(state, sample_indices(state, generator))

    def can_sample(state: ItemBufferState) -> bool:
        return state.num_added >= min_length

    return ItemBuffer(init, add, sample, can_sample, sample_indices, gather)


def make_flat_buffer(max_length: int, min_length: int, sample_batch_size: int,
                     add_batch_size: int = 0) -> ItemBuffer:
    """flashbax's flat-buffer name for the item buffer; `add_batch_size` is
    nominal, as in the JAX package (the add reads the batch's size)."""
    del add_batch_size
    return make_item_buffer(max_length, min_length, sample_batch_size)


# ---------------------------------------------------------------- trajectory buffers


class TrajectoryBufferState(NamedTuple):
    experience: Any  # tree of [add_batch, time_capacity, ...] tensors
    insert_pos: int  # next time slot (shared across rows)
    num_added: int  # time steps ever written a row


class TrajectoryBufferSample(NamedTuple):
    experience: Any  # tree of [batch, sample_sequence_length, ...] tensors


class TrajectoryBuffer(NamedTuple):
    init: Callable[[Any], TrajectoryBufferState]
    add: Callable[[TrajectoryBufferState, Any], TrajectoryBufferState]
    sample: Callable[[TrajectoryBufferState, torch.Generator], TrajectoryBufferSample]
    can_sample: Callable[[TrajectoryBufferState], bool]
    draw: Callable[[TrajectoryBufferState, torch.Generator], Tuple[torch.Tensor, torch.Tensor]]
    sample_from: Callable[[TrajectoryBufferState, torch.Tensor, torch.Tensor],
                          TrajectoryBufferSample]


def _trajectory_init(item: Any, add_batch_size: int, time_capacity: int) -> TrajectoryBufferState:
    experience = tree_map(
        lambda x: torch.zeros((add_batch_size, time_capacity) + tuple(x.shape), dtype=x.dtype,
                              device=x.device), item)
    return TrajectoryBufferState(experience, 0, 0)


def _trajectory_add(state: TrajectoryBufferState, batch: Any,
                    time_capacity: int) -> TrajectoryBufferState:
    """`batch` leaves [add_batch, t_chunk, ...] written at `insert_pos` with
    wraparound. A chunk longer than the buffer keeps only its last
    `time_capacity` steps, the ones a scatter that keeps the last of
    duplicate indices would leave."""
    t_chunk = tree_leaves(batch)[0].shape[1]
    idx = (state.insert_pos + torch.arange(t_chunk, device=_device_of(state.experience))
           ) % time_capacity
    if t_chunk > time_capacity:
        idx = idx[-time_capacity:]
        batch = tree_map(lambda x: x[:, -time_capacity:], batch)
    tree_map(lambda buf, new: buf.index_copy_(1, idx, new.to(buf.dtype)),
             state.experience, batch)
    return TrajectoryBufferState(state.experience, (state.insert_pos + t_chunk) % time_capacity,
                                 state.num_added + t_chunk)


def _valid_starts(state: Any, time_capacity: int, seq_len: int) -> Tuple[int, int]:
    """(number of valid sequence start slots, the oldest valid slot). Once
    the buffer has wrapped a sequence may not cross the write head (those
    steps are not contiguous in experience time), which leaves
    `time_capacity - seq_len` valid starts."""
    if state.num_added <= time_capacity:
        return max(min(state.num_added, time_capacity) - seq_len + 1, 0), 0
    return time_capacity - seq_len, state.insert_pos


def _gather_sequences(experience: Any, rows: torch.Tensor, starts: torch.Tensor,
                      seq_len: int, time_capacity: int) -> Any:
    """[batch, seq_len, ...] sequences: row `rows[b]`, steps `starts[b]` on, wrapping."""
    t_idx = (starts[:, None] + torch.arange(seq_len, device=starts.device)[None, :]
             ) % time_capacity
    return tree_map(lambda buf: buf[rows[:, None], t_idx], experience)


def make_trajectory_buffer(
    add_batch_size: int,
    sample_batch_size: int,
    sample_sequence_length: int,
    period: int = 1,
    max_length_time_axis: int = 10_000,
    min_length_time_axis: int = 1,
) -> TrajectoryBuffer:
    """Time-contiguous sequence buffer (fbx.make_trajectory_buffer's
    counterpart). `period` strides the candidate start positions (period ==
    sequence length gives non-overlapping samples). With nothing sampleable
    written the number of start periods is clamped to 1, so an unguarded
    sample returns zero-filled sequences, as the JAX package's does."""
    time_capacity = int(max_length_time_axis)
    seq_len = int(sample_sequence_length)

    def init(item: Any) -> TrajectoryBufferState:
        return _trajectory_init(item, add_batch_size, time_capacity)

    def add(state: TrajectoryBufferState, batch: Any) -> TrajectoryBufferState:
        return _trajectory_add(state, batch, time_capacity)

    def draw(state: TrajectoryBufferState, generator: torch.Generator
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, start periods): the two uniform draws of `sample`."""
        n_starts, _ = _valid_starts(state, time_capacity, seq_len)
        n_periods = max(n_starts // period, 1)
        device = generator.device
        rows = torch.randint(0, add_batch_size, (sample_batch_size,), generator=generator,
                             device=device)
        start_periods = torch.randint(0, n_periods, (sample_batch_size,), generator=generator,
                                      device=device)
        return rows, start_periods

    def sample_from(state: TrajectoryBufferState, rows: torch.Tensor,
                    start_periods: torch.Tensor) -> TrajectoryBufferSample:
        _, oldest = _valid_starts(state, time_capacity, seq_len)
        starts = (oldest + start_periods * period) % time_capacity
        return TrajectoryBufferSample(_gather_sequences(state.experience, rows, starts, seq_len,
                                                        time_capacity))

    def sample(state: TrajectoryBufferState, generator: torch.Generator) -> TrajectoryBufferSample:
        _guard_sample(can_sample(state), "trajectory buffer")
        return sample_from(state, *draw(state, generator))

    def can_sample(state: TrajectoryBufferState) -> bool:
        return state.num_added >= max(min_length_time_axis, seq_len)

    return TrajectoryBuffer(init, add, sample, can_sample, draw, sample_from)


class PrioritisedTrajectoryBufferState(NamedTuple):
    experience: Any  # tree of [add_batch, time_capacity, ...] tensors
    priorities: torch.Tensor  # [add_batch, num_slots] float32, one a sequence-start slot
    insert_pos: int
    num_added: int


class PrioritisedSample(NamedTuple):
    experience: Any  # tree of [batch, seq_len, ...] tensors
    indices: torch.Tensor  # [batch, 2] (row, slot), for set_priorities
    probabilities: torch.Tensor  # [batch]


class PrioritisedTrajectoryBuffer(NamedTuple):
    init: Callable[[Any], PrioritisedTrajectoryBufferState]
    add: Callable[[PrioritisedTrajectoryBufferState, Any], PrioritisedTrajectoryBufferState]
    sample: Callable[[PrioritisedTrajectoryBufferState, torch.Generator], PrioritisedSample]
    set_priorities: Callable[[PrioritisedTrajectoryBufferState, torch.Tensor, torch.Tensor],
                             PrioritisedTrajectoryBufferState]
    can_sample: Callable[[PrioritisedTrajectoryBufferState], bool]
    sample_from_uniforms: Callable[[PrioritisedTrajectoryBufferState, torch.Tensor],
                                   PrioritisedSample]


def make_prioritised_trajectory_buffer(
    add_batch_size: int,
    sample_batch_size: int,
    sample_sequence_length: int,
    period: int = 1,
    max_length_time_axis: int = 10_000,
    min_length_time_axis: int = 1,
    priority_exponent: float = 0.6,
) -> PrioritisedTrajectoryBuffer:
    """Prioritised sequence replay (Rainbow, R2D2): one priority a
    sequence-start slot, sampled by an inverse CDF over the flattened
    priority table, all on the device."""
    time_capacity = int(max_length_time_axis)
    seq_len = int(sample_sequence_length)
    num_slots = time_capacity // period

    def init(item: Any) -> PrioritisedTrajectoryBufferState:
        base = _trajectory_init(item, add_batch_size, time_capacity)
        priorities = torch.zeros((add_batch_size, num_slots), dtype=torch.float32,
                                 device=_device_of(base.experience))
        return PrioritisedTrajectoryBufferState(base.experience, priorities, 0, 0)

    def add(state: PrioritisedTrajectoryBufferState, batch: Any
            ) -> PrioritisedTrajectoryBufferState:
        """The steps written as the trajectory buffer writes them, then the
        slots from `insert_pos // period` on (as many as the chunk reaches)
        set to max(max(priorities), 1): new data is sampled at least once.
        Slots whose sequences now cross the write head are left to
        `sample`'s validity mask."""
        t_chunk = tree_leaves(batch)[0].shape[1]
        max_prio = torch.clamp_min(state.priorities.max(), 1.0)
        n_new_slots = min((t_chunk + period - 1) // period, num_slots)
        slots = (state.insert_pos // period + torch.arange(
            n_new_slots, device=state.priorities.device)) % num_slots
        state.priorities.index_fill_(1, slots, max_prio)
        base = _trajectory_add(
            TrajectoryBufferState(state.experience, state.insert_pos, state.num_added), batch,
            time_capacity)
        return PrioritisedTrajectoryBufferState(base.experience, state.priorities,
                                                base.insert_pos, base.num_added)

    def sample_from_uniforms(state: PrioritisedTrajectoryBufferState,
                             uniforms: torch.Tensor) -> PrioritisedSample:
        """The sample for `uniforms` [batch] in [0, 1), in the JAX package's order."""
        n_starts, oldest = _valid_starts(state, time_capacity, seq_len)
        device = state.priorities.device
        slot_starts = torch.arange(num_slots, device=device) * period  # a slot's time index
        valid = (slot_starts - oldest) % time_capacity < n_starts
        flat_prio = torch.where(valid[None, :], state.priorities, 0.0).reshape(-1)
        total = torch.sum(flat_prio)
        cdf = torch.cumsum(flat_prio, 0)
        flat_idx = torch.searchsorted(cdf, uniforms * total, right=True)
        flat_idx = torch.clamp(flat_idx, 0, add_batch_size * num_slots - 1)
        rows, slots = flat_idx // num_slots, flat_idx % num_slots
        experience = _gather_sequences(state.experience, rows, slot_starts[slots], seq_len,
                                       time_capacity)
        probs = flat_prio[flat_idx] / torch.clamp_min(total, 1e-9)
        return PrioritisedSample(experience, torch.stack([rows, slots], dim=-1), probs)

    def sample(state: PrioritisedTrajectoryBufferState,
               generator: torch.Generator) -> PrioritisedSample:
        _guard_sample(can_sample(state), "prioritised trajectory buffer")
        uniforms = torch.rand((sample_batch_size,), generator=generator, device=generator.device)
        return sample_from_uniforms(state, uniforms)

    def set_priorities(state: PrioritisedTrajectoryBufferState, indices: torch.Tensor,
                       priorities: torch.Tensor) -> PrioritisedTrajectoryBufferState:
        """(|p| + 1e-6) ** priority_exponent at each (row, slot), in place.
        Where an index repeats, the LAST occurrence's value wins, as JAX's
        `.at[].set` keeps it on the CPU. A scatter with duplicate indices has
        no defined winner on the card, so every duplicate first takes the
        value of the last occurrence of its index (a stable sort of the flat
        indices; the end of each run of equal ones found by a right-sided
        search): then any winner writes the same bits, on any device and
        from run to run, with no host synchronisation."""
        flat = indices[:, 0] * num_slots + indices[:, 1]
        values = torch.pow(torch.abs(priorities) + 1e-6, priority_exponent)
        set_last_of_duplicates(state.priorities.view(-1), flat, values)
        return state

    def can_sample(state: PrioritisedTrajectoryBufferState) -> bool:
        return state.num_added >= max(min_length_time_axis, seq_len)

    return PrioritisedTrajectoryBuffer(init, add, sample, set_priorities, can_sample,
                                       sample_from_uniforms)


def set_last_of_duplicates(table: torch.Tensor, index: torch.Tensor,
                           values: torch.Tensor) -> torch.Tensor:
    """`table[index] = values` in place, the LAST occurrence winning where an
    index repeats, as JAX's `.at[].set` on the CPU. A scatter with duplicate
    indices has no defined winner on the card, so every duplicate first
    takes the value of the last occurrence of its index (a stable sort of
    the indices; the end of each run of equal ones found by a right-sided
    search): any winner then writes the same bits, on any device, with no
    host synchronisation."""
    sorted_index, order = torch.sort(index, stable=True)
    last = torch.searchsorted(sorted_index, index, right=True) - 1
    return table.index_put_((index,), values[order][last])


def duplicate_indices(indices: torch.Tensor) -> int:
    """How many entries of an [batch, 2] (row, slot) index tensor repeat an
    earlier one: what `set_priorities` collapses. Reads the device."""
    return int(indices.shape[0]) - int(torch.unique(indices, dim=0).shape[0])
