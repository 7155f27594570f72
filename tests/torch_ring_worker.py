"""Multi-process CPU harness for the PyTorch port's distributed tests
(tests/test_torch_ring_attention.py, tests/test_torch_ring_grad.py,
tests/test_torch_parallel.py, tests/test_torch_data_parallel.py,
tests/test_torch_gossip.py, tests/test_torch_tp.py,
tests/test_torch_population.py).

`spawn_ranks(jobs, world, tmp_dir)` starts `world` processes of

    python tests/torch_ring_worker.py RANK WORLD TMP_DIR

Each rank joins one gloo process group through
`stoix_tpu_torch.parallel.maybe_initialize_distributed`, with a `file://`
store in TMP_DIR (no network), runs every job of `jobs` in order, and returns
{job name: result}. A job is (name, kind, keyword arguments): the kinds are
the functions in `KINDS`, the data-parallel ones in tests/torch_dp_worker.py,
the gossip and tensor-parallel ones in tests/torch_gossip_worker.py, the
population's in tests/torch_population_worker.py.
This module imports no JAX, so each rank starts in about a second.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from stoix_tpu_torch.kernels import flash_attention_chunk
from stoix_tpu_torch.networks.attention import TransformerTorso
from stoix_tpu_torch.ops.ring_attention import make_ring_attention, ring_attention
from stoix_tpu_torch.parallel import (
    axis_size, create_mesh, is_coordinator, maybe_initialize_distributed, process_allgather,
)
from stoix_tpu_torch.utils.config import Config
from stoix_tpu_torch.utils.params import load_flax_params
from torch_dp_worker import DP_KINDS
from torch_population_worker import POPULATION_KINDS
from torch_gossip_worker import GOSSIP_KINDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 240.0


def _shard(x: np.ndarray, group) -> torch.Tensor:
    """This rank's shard of a [B, S, ...] array along S, by its rank in `group`."""
    count, index = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[1] // count
    return torch.from_numpy(np.ascontiguousarray(x[:, index * size:(index + 1) * size]))


def _ring(mesh_for, axes, axis, q, k, v, causal, use_flash="default"):
    """This rank's output shard of ring attention over `axis`; use_flash
    "default" goes through `make_ring_attention`."""
    mesh = mesh_for(axes)
    group = mesh.get_group(axis)
    if use_flash == "default":
        attend = make_ring_attention(mesh, axis, causal)
    else:
        attend = partial(ring_attention, group=group, causal=causal, use_flash=use_flash)
    return attend(*(_shard(x, group) for x in (q, k, v))).numpy()


def _ring_grad(mesh_for, axes, axis, q, k, v, cotangent, causal, use_flash=None):
    """This rank's output shard of ring attention over `axis` and the
    gradients of sum(output * cotangent) with respect to its q, k, v shards;
    under use_flash=True the refusal's message instead."""
    group = mesh_for(axes).get_group(axis)
    q, k, v = (_shard(x, group).requires_grad_(True) for x in (q, k, v))
    try:
        out = ring_attention(q, k, v, group, causal=causal, use_flash=use_flash)
    except NotImplementedError as error:
        return {"refused": str(error)}
    (out * _shard(cotangent, group)).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


def _torso(mesh_for, params, x, torso_kwargs):
    """This rank's output shard of a transformer torso whose attention is the
    ring over the "data" axis, carrying flax `params`."""
    group = mesh_for({"data": -1}).get_group("data")
    torso = TransformerTorso(x.shape[-1], **torso_kwargs,
                             attention_fn=partial(ring_attention, group=group))
    load_flax_params(torso, params)
    with torch.no_grad():
        return torso(_shard(x, group)).numpy()


def _mesh(mesh_for, axes):
    mesh = mesh_for(axes)
    names = mesh.mesh_dim_names
    return {
        "shape": tuple(mesh.shape),
        "names": tuple(names),
        "axis_size": {a: axis_size(mesh, a) for a in names},
        "group_size": {a: dist.get_world_size(mesh.get_group(a)) for a in names},
        "group_rank": {a: dist.get_rank(mesh.get_group(a)) for a in names},
        "coordinate": tuple(mesh.get_coordinate()),
    }


def _collectives(mesh_for):
    rank = dist.get_rank()
    return {
        "tensor": process_allgather(torch.tensor([rank, 10 * rank])).numpy(),
        "objects": process_allgather({"rank": rank}),
        "coordinator": is_coordinator(),
    }


KINDS = {"ring": _ring, "ring_grad": _ring_grad, "torso": _torso, "mesh": _mesh,
         "collectives": _collectives, **DP_KINDS, **GOSSIP_KINDS, **POPULATION_KINDS}


def main(rank: int, world: int, tmp_dir: str) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(tmp_dir, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    config = Config.from_dict({"arch": {"distributed": {
        "coordinator_address": "file://" + os.path.join(tmp_dir, "store"),
        "num_processes": world, "process_id": rank,
    }}})
    maybe_initialize_distributed(config, device="cpu")
    meshes = {}

    def mesh_for(axes):
        # One mesh per axes spec: every rank builds them in the same order.
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = create_mesh(axes, device="cpu")
        return meshes[key]

    try:
        results = {name: KINDS[kind](mesh_for, **kwargs) for name, kind, kwargs in jobs}
        results["chunk_kernel_launches"] = flash_attention_chunk.KERNEL.launches
    finally:
        dist.destroy_process_group()
    out = os.path.join(tmp_dir, f"rank{rank}.pkl")
    with open(out + ".tmp", "wb") as f:
        pickle.dump(results, f)
    os.replace(out + ".tmp", out)


def spawn_ranks(jobs, world: int, tmp_dir: str, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Run `jobs` on `world` gloo ranks; returns each rank's {name: result},
    in rank order. Raises, with every rank's log, if a rank fails or the ranks
    are not done within `timeout` seconds (the others are then killed)."""
    tmp_dir = str(tmp_dir)
    with open(os.path.join(tmp_dir, "jobs.pkl"), "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    logs = [os.path.join(tmp_dir, f"rank{r}.log") for r in range(world)]
    procs = []
    for rank, log in enumerate(logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank), str(world), tmp_dir],
                stdout=out, stderr=subprocess.STDOUT, env=env, cwd=REPO,
            ))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode for p in procs):
                break  # one rank failed: the others would wait on it forever
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    codes = [p.returncode for p in procs]
    if any(codes):
        text = "\n".join(f"--- rank {r} (exit {c}) ---\n{open(log).read()}"
                         for r, (c, log) in enumerate(zip(codes, logs)))
        raise RuntimeError(f"ranks exited with {codes} (timeout {timeout} s):\n{text}")
    results = []
    for rank in range(world):
        with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
