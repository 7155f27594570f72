"""The PyTorch port's process layer (stoix_tpu_torch/parallel) against the JAX
package's (stoix_tpu/parallel), on the CPU.

- `mesh_shape` keeps `create_mesh`'s size arithmetic and errors: the same axes
  give the same sizes, or the same ValueError, over the same device count.
- `create_mesh`, `axis_size`, `process_allgather` and `is_coordinator` on 4
  gloo ranks (spawned processes, tests/torch_ring_worker.py, one spawn for the
  module), each rank joining through `maybe_initialize_distributed` with a
  `file://` coordinator.
- The half-configured launch refusal of tests/test_fleet.py:493-512, with
  torchrun's variables in place of JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from stoix_tpu.parallel import create_mesh as jax_create_mesh
from stoix_tpu_torch.parallel import (
    create_mesh, is_coordinator, maybe_initialize_distributed, mesh_shape, process_allgather,
)
from stoix_tpu_torch.resilience.errors import ConfigValidationError
from stoix_tpu_torch.utils.config import Config
from torch_ring_worker import spawn_ranks

WORLD = 4


@pytest.mark.parametrize("axes,devices", [
    (None, 8),
    ({"data": -1}, 4),
    ({"data": 2, "seq": -1}, 8),
    ({"data": -1, "seq": 2}, 4),
    ({"data": 1, "seq": -1}, 4),
    ({"data": 4}, 4),
    ({"a": 2, "b": 2, "c": -1}, 8),
])
def test_mesh_shape_matches_jax_create_mesh(axes, devices):
    want = jax_create_mesh(axes, devices=jax.devices()[:devices]).shape
    assert mesh_shape(axes, devices) == dict(want)


@pytest.mark.parametrize("axes,devices,match", [
    ({"data": -1, "seq": -1}, 4, "At most one mesh axis may be -1"),
    ({"data": 3, "seq": -1}, 8, "not divisible by fixed axes"),
    ({"data": 3}, 4, "do not cover 4 devices"),
    ({"data": 2, "seq": 2}, 8, "do not cover 8 devices"),
])
def test_mesh_shape_refuses_what_jax_create_mesh_refuses(axes, devices, match):
    with pytest.raises(ValueError, match=match):
        jax_create_mesh(axes, devices=jax.devices()[:devices])
    with pytest.raises(ValueError, match=match):
        mesh_shape(axes, devices)


def test_create_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="maybe_initialize_distributed"):
        create_mesh({"data": -1}, device="cpu")


def test_single_process_gathers_and_coordinates():
    assert is_coordinator()
    gathered = process_allgather(torch.tensor([1.0, 2.0]))
    assert gathered.shape == (1, 2) and torch.equal(gathered[0], torch.tensor([1.0, 2.0]))
    assert process_allgather({"a": 1}) == [{"a": 1}]


def test_half_configured_distributed_launch_raises(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    # Plain single-process: still a no-op.
    maybe_initialize_distributed(None, device="cpu")
    # Config variant: num_processes declared, no coordinator anywhere.
    cfg = Config.from_dict({"arch": {"distributed": {"num_processes": 4}}})
    with pytest.raises(ConfigValidationError, match="num_processes=4"):
        maybe_initialize_distributed(cfg, device="cpu")
    # Environment-only variant (torchrun's WORLD_SIZE).
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ConfigValidationError, match="WORLD_SIZE"):
        maybe_initialize_distributed(None, device="cpu")
    # An address alone is no coordinator: MASTER_PORT is missing.
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(ConfigValidationError, match="MASTER_ADDR and MASTER_PORT"):
        maybe_initialize_distributed(None, device="cpu")
    # Declared but single process: fine.
    monkeypatch.setenv("WORLD_SIZE", "1")
    maybe_initialize_distributed(None, device="cpu")
    assert not torch.distributed.is_initialized()


MESHES = [{"data": -1}, {"data": 2, "seq": -1}, {"data": 1, "seq": -1}]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jobs = [(f"mesh-{i}", "mesh", dict(axes=axes)) for i, axes in enumerate(MESHES)]
    jobs.append(("collectives", "collectives", {}))
    return spawn_ranks(jobs, WORLD, tmp_path_factory.mktemp("parallel_ranks"))


@pytest.mark.parametrize("index", range(len(MESHES)))
def test_create_mesh_on_four_ranks(ranks, index):
    axes = MESHES[index]
    shape = mesh_shape(axes, WORLD)
    want_grid = np.arange(WORLD).reshape(tuple(shape.values()))
    for rank, result in enumerate(ranks):
        mesh = result[f"mesh-{index}"]
        assert mesh["names"] == tuple(shape) and mesh["shape"] == tuple(shape.values())
        assert mesh["axis_size"] == shape == mesh["group_size"]
        # Ranks fill the mesh row-major; a rank's place in an axis's group is
        # its coordinate on that axis.
        coordinate = tuple(int(c) for c in np.argwhere(want_grid == rank)[0])
        assert mesh["coordinate"] == coordinate
        assert tuple(mesh["group_rank"].values()) == coordinate


def test_process_allgather_and_coordinator_on_four_ranks(ranks):
    for rank, result in enumerate(ranks):
        gathered = result["collectives"]
        np.testing.assert_array_equal(gathered["tensor"],
                                      [[r, 10 * r] for r in range(WORLD)])
        assert gathered["objects"] == [{"rank": r} for r in range(WORLD)]
        assert gathered["coordinator"] == (rank == 0)
