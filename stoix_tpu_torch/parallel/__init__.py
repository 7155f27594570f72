"""Processes and meshes on `torch.distributed` (counterpart of
stoix_tpu/parallel): initialisation, host-side gathers, the named-axis mesh
that data-parallel training and ring attention run over, and a rank's shards
of it. Importing it initialises nothing."""

from stoix_tpu_torch.parallel.distributed import (
    is_coordinator,
    maybe_initialize_distributed,
    process_allgather,
    process_count,
)
from stoix_tpu_torch.parallel.mesh import (
    axis_size,
    create_mesh,
    fetch_global,
    materialize,
    mesh_shape,
    replicate,
    shard_leading_axis,
)

__all__ = [
    "axis_size",
    "create_mesh",
    "fetch_global",
    "is_coordinator",
    "materialize",
    "maybe_initialize_distributed",
    "mesh_shape",
    "process_allgather",
    "process_count",
    "replicate",
    "shard_leading_axis",
]
