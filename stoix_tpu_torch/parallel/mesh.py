"""The process mesh (counterpart of stoix_tpu/parallel/mesh.py: `create_mesh`,
`axis_size`, `shard_leading_axis`, `replicate`, `fetch_global` and
`materialize`).

The JAX package builds one `jax.sharding.Mesh` over every chip of the job
with named axes ("data" first). The port builds a
`torch.distributed.device_mesh.DeviceMesh` over the processes of the
initialised process group (one card each), with the same axis names and the
same size arithmetic. A collective on one axis takes that axis's process
group, `mesh.get_group(axis)`.

A process holds only its own shard, so where the JAX package places a global
array with a sharding, the port takes the rank's slice (`shard_leading_axis`)
or broadcasts rank 0's copy (`replicate`); `replicated_sharding` and
`data_sharding` name placements and have no counterpart. `fetch_global`
gathers every rank's shard along an axis to the host, as the JAX one brings
a sharded global array to every host. Sebulba's `assemble_global_array`
has no counterpart here: in one process the learner's "global array" is its
list of per-device shards, each the actors' payloads concatenated on the env
axis (systems/ppo/sebulba/ff_ppo.py::assemble_batch).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from stoix_tpu_torch.utils.tree import tree_leaves, tree_map


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


def _rank_and_size(mesh: DeviceMesh, axis: str):
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def shard_leading_axis(tree: Any, mesh: DeviceMesh, axis: str = "data", dim: int = 0) -> Any:
    """This rank's shard of every tensor leaf: axis `dim` cut into as many
    equal parts as `axis` has ranks, the rank's index-th (the JAX package
    places the global array sharded over `axis` instead)."""
    _, rank, size = _rank_and_size(mesh, axis)

    def cut(x: torch.Tensor) -> torch.Tensor:
        if x.shape[dim] % size:
            raise ValueError(f"axis {dim} of size {x.shape[dim]} does not split over "
                             f"{size} ranks of mesh axis {axis!r}")
        width = x.shape[dim] // size
        return x.narrow(dim, rank * width, width)

    return tree_map(cut, tree)


def _on_backend(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Where `group`'s backend takes the tensor: NCCL on the card, gloo on the host."""
    return x.contiguous() if dist.get_backend(group) == "nccl" else x.detach().cpu()


def replicate(tree: Any, mesh: DeviceMesh, axis: str = "data") -> Any:
    """Every tensor leaf as the first rank of `axis` holds it, on each rank's
    own device."""
    group, _, _ = _rank_and_size(mesh, axis)
    source = dist.get_global_rank(group, 0)

    def broadcast(x: torch.Tensor) -> torch.Tensor:
        y = _on_backend(x, group).clone()
        dist.broadcast(y, src=source, group=group)
        return y.to(x.device)

    return tree_map(broadcast, tree)


def materialize(tree: Any) -> Any:
    """Every tensor leaf as a numpy array on the host."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def fetch_global(tree: Any, mesh: Optional[DeviceMesh] = None, axis: Optional[str] = "data",
                 dim: int = 0) -> Any:
    """The global arrays of a tree of per-rank shards, as numpy on every
    rank: each tensor leaf gathered over `axis` (every rank of the mesh when
    None) and concatenated along `dim` in rank order. With no mesh (a single
    process) the tree as it is, as the JAX package's `fetch_global_async`
    returns it. Every rank must call it: it runs ONE collective, an
    all-gather of the leaves' bytes side by side, so a leaf added to the tree
    (the fleet's per-rank payload) rides the same gather."""
    if mesh is None:
        return tree
    if axis is None:
        group, size = dist.group.WORLD, dist.get_world_size()
    else:
        group, _, size = _rank_and_size(mesh, axis)
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    local = [_on_backend(x, group) for x in leaves]
    device = local[0].device
    flat = torch.cat([x.reshape(-1).view(torch.uint8) if x.dtype != torch.bool
                      else x.reshape(-1).to(torch.uint8) for x in (y.to(device) for y in local)])
    parts = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(parts, flat, group=group)
    gathered = []
    offset = 0
    for x in local:
        width = x.numel() * x.element_size()
        shards = []
        for part in parts:
            raw = part[offset:offset + width]
            shard = raw.to(torch.bool) if x.dtype == torch.bool else raw.clone().view(x.dtype)
            shards.append(shard.reshape(x.shape))
        gathered.append(materialize(torch.cat(shards, dim=dim)))
        offset += width
    placed = iter(gathered)
    return tree_map(lambda _: next(placed), tree)
