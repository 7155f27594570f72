"""The process mesh (counterpart of stoix_tpu/parallel/mesh.py: `create_mesh`
and `axis_size`).

The JAX package builds one `jax.sharding.Mesh` over every chip of the job
with named axes ("data" first). The port builds a
`torch.distributed.device_mesh.DeviceMesh` over the processes of the
initialised process group (one card each), with the same axis names and the
same size arithmetic. A collective on one axis takes that axis's process
group, `mesh.get_group(axis)`. The rest of the JAX module (sharding helpers,
global fetches, `assemble_global_array`) serves data-parallel training and
Sebulba and is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def mesh_shape(axes: Optional[Dict[str, int]], world_size: int) -> Dict[str, int]:
    """{axis_name: size} with one size of -1 inferred; the sizes must cover
    `world_size` processes exactly (the JAX package's `create_mesh` rules)."""
    axes = dict(axes or {"data": -1})
    sizes = list(axes.values())
    n = int(world_size)
    if sizes.count(-1) > 1:
        raise ValueError("At most one mesh axis may be -1")
    if -1 in sizes:
        known = 1
        for size in sizes:
            if size != -1:
                known *= int(size)
        if known <= 0 or n % known != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes {axes}")
        sizes[sizes.index(-1)] = n // known
    total = 1
    for size in sizes:
        total *= int(size)
    if total != n:
        raise ValueError(f"Mesh axes {dict(zip(axes, sizes))} do not cover {n} devices")
    return {name: int(size) for name, size in zip(axes, sizes)}


def create_mesh(axes: Optional[Dict[str, int]] = None, device: str = "cuda") -> DeviceMesh:
    """A DeviceMesh over every process of the initialised process group, from
    {axis_name: size}; one size may be -1 (inferred). Defaults to a pure
    data-parallel mesh. Ranks fill the mesh in row-major order."""
    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs an initialised process group: call "
            "stoix_tpu_torch.parallel.maybe_initialize_distributed first"
        )
    shape = mesh_shape(axes, dist.get_world_size())
    ranks = torch.arange(dist.get_world_size()).reshape(tuple(shape.values()))
    return DeviceMesh(device, ranks, mesh_dim_names=tuple(shape))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))
