"""On-device replay buffers (counterpart of stoix_tpu/buffers)."""

from stoix_tpu_torch.buffers.buffers import (
    EmptyBufferSampleError,
    ItemBuffer,
    ItemBufferSample,
    ItemBufferState,
    PrioritisedSample,
    PrioritisedTrajectoryBuffer,
    PrioritisedTrajectoryBufferState,
    TrajectoryBuffer,
    TrajectoryBufferSample,
    TrajectoryBufferState,
    make_flat_buffer,
    make_item_buffer,
    make_prioritised_trajectory_buffer,
    make_trajectory_buffer,
    set_sample_guard,
)

__all__ = [
    "EmptyBufferSampleError",
    "ItemBuffer",
    "ItemBufferSample",
    "ItemBufferState",
    "PrioritisedSample",
    "PrioritisedTrajectoryBuffer",
    "PrioritisedTrajectoryBufferState",
    "TrajectoryBuffer",
    "TrajectoryBufferSample",
    "TrajectoryBufferState",
    "make_flat_buffer",
    "make_item_buffer",
    "make_prioritised_trajectory_buffer",
    "make_trajectory_buffer",
    "set_sample_guard",
]
