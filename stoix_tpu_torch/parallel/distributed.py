"""Multi-process initialisation and host-side coordination on
`torch.distributed` (counterpart of stoix_tpu/parallel/distributed.py).

Call `maybe_initialize_distributed()` before building a mesh
(parallel/mesh.py). Where the JAX package reads JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES and JAX_PROCESS_ID, the port reads what `torchrun` sets:
MASTER_ADDR and MASTER_PORT, WORLD_SIZE and RANK. The keys
`arch.distributed.{coordinator_address, num_processes, process_id}` win over
them. Importing this module initialises nothing.

The fleet's key-value store (resilience/fleet.py) is a client of the same
coordinator: `FleetStoreBackend` speaks the JAX package's backend protocol
(`put`, `try_get`, `get_blocking`, `barrier`) under its `stoix_tpu/fleet/`
key prefix, on a `torch.distributed.TCPStore` client for a `tcp://`
coordinator (the store rank 0's process group serves) or a `FileStore` for
a `file://` one. `live_backend(config)` builds it when the default group
has more than one process.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Any, Optional, Tuple
from urllib.parse import urlparse

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


def coordinator_address(config: Optional[Any] = None) -> Optional[str]:
    """The coordinator a launch declares, as an init-method URL:
    `arch.distributed.coordinator_address`, else MASTER_ADDR:MASTER_PORT;
    None when neither is set."""
    dist_cfg = getattr(getattr(config, "arch", None), "distributed", None) if config else None
    if dist_cfg and dist_cfg.get("coordinator_address"):
        return _init_method(str(dist_cfg["coordinator_address"]))
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


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
    coordinator = coordinator_address(config)
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


# ---------------------------------------------------------------------------
# The fleet's key-value store
# ---------------------------------------------------------------------------

FLEET_PREFIX = "stoix_tpu/fleet/"
_POLL_S = 0.02  # the poll of a bounded wait
_CONNECT_TIMEOUT = datetime.timedelta(seconds=30)


class FleetStoreBackend:
    """One process's view of the fleet store (the protocol of the JAX
    package's JaxKVBackend and FakeFleetBackend), every key under
    `stoix_tpu/fleet/`.

    Each thread gets a store client of its own (a TCP connection, or a
    FileStore handle on the shared file), so the heartbeat publisher, the
    peer monitor, the metrics publisher and the main thread's votes never
    wait on one another's requests. A read of a missing key answers at once:
    `try_get` is a `check` then a `get`, and `get_blocking` a wait with a
    deadline, polled with `check` (a TCPStore `get` of a missing key blocks
    until the store's timeout, and FileStore's `wait` rounds its timeout up
    to whole seconds). A store that cannot be reached answers None, as the
    JAX backend's failed RPC does: the monitor reads a peer it cannot see as
    a stale one."""

    def __init__(self, address: str, process_index: int, process_count: int):
        parsed = urlparse(address)
        if parsed.scheme not in ("tcp", "file"):
            raise ValueError(f"the fleet store needs a tcp:// or file:// coordinator, got "
                             f"{address!r}")
        self.address = address
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self._local = threading.local()
        self._client()  # the caller's thread connects now: an unreachable store raises here

    def _client(self) -> Any:
        client = getattr(self._local, "client", None)
        if client is None:
            parsed = urlparse(self.address)
            if parsed.scheme == "tcp":
                client = dist.TCPStore(parsed.hostname, int(parsed.port), is_master=False,
                                       timeout=_CONNECT_TIMEOUT, wait_for_workers=False)
            else:
                client = dist.FileStore(parsed.path, -1)
            self._local.client = client
        return client

    @staticmethod
    def _k(key: str) -> str:
        return FLEET_PREFIX + key

    def put(self, key: str, value: str) -> None:
        self._client().set(self._k(key), str(value))

    def try_get(self, key: str) -> Optional[str]:
        try:
            client = self._client()
            if not client.check([self._k(key)]):
                return None
            return client.get(self._k(key)).decode()
        except Exception:  # noqa: BLE001 -- an unreachable store reads as no value
            return None

    def get_blocking(self, key: str, timeout_s: float) -> Optional[str]:
        deadline = time.monotonic() + float(timeout_s)
        while True:
            value = self.try_get(key)
            if value is not None or time.monotonic() >= deadline:
                return value
            time.sleep(_POLL_S)

    def barrier(self, name: str, timeout_s: float) -> bool:
        """Arrive at barrier `name` and wait until every process has, within
        `timeout_s` (False past it). One counter a barrier name."""
        key = self._k(f"barrier/{name}")
        deadline = time.monotonic() + float(timeout_s)
        try:
            arrived = self._client().add(key, 1)
            while arrived < self.process_count:
                if time.monotonic() >= deadline:
                    return False
                time.sleep(_POLL_S)
                arrived = self._client().add(key, 0)
            return True
        except Exception:  # noqa: BLE001 -- the caller raises the typed timeout
            return False


def live_backend(config: Optional[Any] = None) -> Optional[FleetStoreBackend]:
    """The fleet store of the default process group when it has more than
    one process (None for a single process, which needs no store). A group
    with no coordinator the config or the environment names, or a store that
    cannot be reached, raises naming `arch.fleet`: a fleet run never goes on
    without coordination."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    address = coordinator_address(config)
    if address is None:
        raise ConfigValidationError([
            "arch.fleet.enabled=true over a process group of "
            f"{dist.get_world_size()} processes, but no coordinator address is set "
            "(arch.distributed.coordinator_address, or MASTER_ADDR and MASTER_PORT): the "
            "fleet store cannot be reached"])
    try:
        return FleetStoreBackend(address, dist.get_rank(), dist.get_world_size())
    except Exception as exc:  # noqa: BLE001 -- re-raised, naming the key
        raise ConfigValidationError([
            f"arch.fleet.enabled=true: the fleet store at {address} cannot be reached "
            f"({type(exc).__name__}: {exc})"]) from exc
