"""Multi-process initialisation and host-side coordination on
`torch.distributed` (counterpart of stoix_tpu/parallel/distributed.py).

Call `maybe_initialize_distributed()` before building a mesh
(parallel/mesh.py). Where the JAX package reads JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES and JAX_PROCESS_ID, the port reads what `torchrun` sets:
MASTER_ADDR and MASTER_PORT, WORLD_SIZE and RANK. The keys
`arch.distributed.{coordinator_address, num_processes, process_id}` win over
them. Importing this module initialises nothing.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from stoix_tpu_torch.resilience.errors import ConfigValidationError

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _init_method(address: str) -> str:
    """`host:port` -> `tcp://host:port`; an address with a scheme (`tcp://`,
    `file://`) is taken as it is."""
    return address if "://" in address else f"tcp://{address}"


def _declared(dist_cfg: Optional[Any], key: str, env: str) -> Tuple[Optional[str], str]:
    """(value, where it was set) of a config key, or else of an environment variable."""
    if dist_cfg and dist_cfg.get(key) not in (None, "~"):
        return str(dist_cfg[key]), f"arch.distributed.{key}"
    return os.environ.get(env) or None, env


def maybe_initialize_distributed(config: Optional[Any] = None, device: str = "cuda") -> None:
    """Initialise the default process group when the launch declares a
    coordinator: NCCL for device="cuda", gloo for device="cpu". A no-op when
    no coordinator is declared (a single process), or when the group is
    already initialised.

    The coordinator is `arch.distributed.coordinator_address` (`host:port`, or
    a `tcp://` or `file://` URL), else MASTER_ADDR:MASTER_PORT; the world size
    and rank are `arch.distributed.num_processes` / `process_id`, else
    WORLD_SIZE / RANK.

    A HALF-configured launch — more than one process declared (config or
    environment) but no coordinator anywhere — raises ConfigValidationError
    naming the key or variable instead of running single-process: that run
    would train 1/N of the batch with every cross-process collective a local
    no-op and no error anywhere.
    """
    if dist.is_initialized():
        return
    dist_cfg = getattr(getattr(config, "arch", None), "distributed", None) if config else None
    coordinator = None
    if dist_cfg and dist_cfg.get("coordinator_address"):
        coordinator = _init_method(str(dist_cfg["coordinator_address"]))
    elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    num_processes, source = _declared(dist_cfg, "num_processes", "WORLD_SIZE")

    if coordinator is None:
        if num_processes is not None and int(num_processes) > 1:
            raise ConfigValidationError([
                f"{source}={num_processes} declares a multi-process launch but no "
                f"coordinator address is set (MASTER_ADDR and MASTER_PORT, or "
                f"arch.distributed.coordinator_address): refusing to silently run "
                f"single-process — this launch would train 1/{int(num_processes)} of the "
                f"batch with every cross-process collective a local no-op and no error "
                f"anywhere"
            ])
        return  # single process

    if device not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}; use 'cuda' or 'cpu'")
    rank = int(_declared(dist_cfg, "process_id", "RANK")[0] or 0)
    if device == "cuda":
        local_rank = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local_rank) if local_rank else rank % torch.cuda.device_count())
    dist.init_process_group(_BACKENDS[device], init_method=coordinator,
                            world_size=int(num_processes or 1), rank=rank)


def process_count() -> int:
    """The processes of the default group (1 with none), as
    `jax.process_count()`."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on process 0 (and in a single process): gate logging,
    checkpointing and eval printing on this."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_allgather(x: Any) -> Any:
    """Gather a host-local value from every process, in rank order: a tensor
    comes back stacked along a new leading axis [P, ...], any other picklable
    value as a list of P values. A single process gets the same shapes
    ([1, ...] and a one-element list), where the JAX package returns its value
    unstacked. Under NCCL a tensor must lie on the process's card."""
    if not dist.is_initialized():
        return x[None] if isinstance(x, torch.Tensor) else [x]
    world = dist.get_world_size()
    if isinstance(x, torch.Tensor):
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x.contiguous())
        return torch.stack(out)
    out = [None] * world
    dist.all_gather_object(out, x)
    return out
