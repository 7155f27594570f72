"""Processes and meshes on `torch.distributed` (counterpart of
stoix_tpu/parallel): initialisation, host-side gathers, and the named-axis
mesh ring attention runs over. Importing it initialises nothing."""

from stoix_tpu_torch.parallel.distributed import (
    is_coordinator,
    maybe_initialize_distributed,
    process_allgather,
)
from stoix_tpu_torch.parallel.mesh import axis_size, create_mesh, mesh_shape

__all__ = [
    "axis_size",
    "create_mesh",
    "is_coordinator",
    "maybe_initialize_distributed",
    "mesh_shape",
    "process_allgather",
]
