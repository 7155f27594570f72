"""The uniform item buffer (counterpart of
stoix_tpu/buffers/buffers.py::make_item_buffer, the flashbax item buffer the
JAX package's value-based family replays from).

The buffer lives on the device: `init` preallocates one [capacity, ...]
tensor for every leaf of an item tree (zeros, as the JAX package's). `add`
writes a batch of items at `(insert_pos + arange(n)) % capacity` with
`index_copy_`: IN PLACE, since the preallocated tensors are the buffer's one
copy of the experience (the JAX package returns new arrays); the state it
returns shares them. `sample` draws `sample_batch_size` indices uniformly
from the items written so far with `torch.randint` on an explicit
generator, then gathers them: `sample_indices` and `gather` are its two
halves, so a test can feed the indices JAX drew.

`insert_pos` and `num_added` are host ints. The Anakin fill is
deterministic (warmup steps x envs, then rollout x envs an update), so the
host knows both without reading the device, and `torch.randint` takes its
bound from the host; the epsilon schedule that reads `num_added` computes on
the host too. Nothing here synchronises with the device.

Not ported: the trajectory and prioritised buffers and the debug sample
guard of the JAX package (`STOIX_TPU_BUFFER_DEBUG`): the host counts say
whether a sample is possible (`can_sample`) without a device read.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from stoix_tpu_torch.utils.tree import tree_leaves, tree_map


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
        device = tree_leaves(state.experience)[0].device
        idx = (state.insert_pos + torch.arange(n, device=device)) % max_length
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
        return gather(state, sample_indices(state, generator))

    def can_sample(state: ItemBufferState) -> bool:
        return state.num_added >= min_length

    return ItemBuffer(init, add, sample, can_sample, sample_indices, gather)
