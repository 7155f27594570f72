"""Device introspection sampled off the hot path (counterpart of
stoix_tpu/observability/introspect.py).

A daemon thread polls the card's caching allocator
(`torch.cuda.memory_stats()`: counters the allocator keeps on the host, so a
poll never joins the device stream) and the card's free and total memory
(`torch.cuda.mem_get_info()`), publishing the JAX package's gauge:

    stoix_tpu_device_memory_bytes{device=..., kind=bytes_in_use|peak_bytes_in_use|
                                  num_allocs|bytes_limit,
                                  source=memory_stats|mem_get_info}
    stoix_tpu_device_poll_errors_total{}

`bytes_in_use`, `peak_bytes_in_use` and `num_allocs` are the allocator's
`allocated_bytes.all.current`, `allocated_bytes.all.peak` and
`allocation.all.current`; `bytes_limit` is the card's total memory. A CPU run never polls: sampling
does nothing unless this process has initialised CUDA, so it neither
initialises a card nor reads one a CPU run does not use. Only the cards this
process has allocated on are read: `memory_stats` is the allocator's host
bookkeeping, but `mem_get_info` makes a CUDA context on the card it asks, so
asking every visible card would open one on each from every rank of a
data-parallel run.
"""

from __future__ import annotations

import threading
from typing import Optional

from stoix_tpu_torch.observability.registry import MetricsRegistry, get_registry

# memory_stats() keys that feed the JAX package's kinds.
_ALLOCATOR_KINDS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "num_allocs": "allocation.all.current",
}
# Bytes ever allocated on the card (reset by no peak reset): non-zero once
# this process has a context there.
_EVER_ALLOCATED = "allocated_bytes.all.allocated"


def sample_device_telemetry(registry: Optional[MetricsRegistry] = None) -> int:
    """One synchronous sample (also the poller's body); returns the number of
    memory series updated (0 when this process has not initialised CUDA)."""
    import torch

    registry = registry or get_registry()
    mem_gauge = registry.gauge(
        "stoix_tpu_device_memory_bytes",
        "Per-device allocator stats from torch.cuda.memory_stats() and mem_get_info()",
    )
    err_counter = registry.counter(
        "stoix_tpu_device_poll_errors_total",
        "Introspection sampling errors (backend gaps count once per poll)",
    )
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return 0
    updated = 0
    for device in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(device)
            if not stats.get(_EVER_ALLOCATED):
                continue  # no allocation here: maybe no context either
            sample = {kind: float(stats[key]) for kind, key in _ALLOCATOR_KINDS.items()
                      if key in stats}
            sample["bytes_limit"] = float(torch.cuda.mem_get_info(device)[1])
        except RuntimeError:
            err_counter.inc()
            continue
        label = f"cuda:{device}"
        for kind, value in sample.items():
            source = "mem_get_info" if kind == "bytes_limit" else "memory_stats"
            mem_gauge.set(value, {"device": label, "kind": kind, "source": source})
            updated += 1
    return updated


class DeviceTelemetryPoller:
    """Daemon polling thread; `interval_s <= 0` disables it entirely."""

    def __init__(self, interval_s: float = 5.0,
                 registry: Optional[MetricsRegistry] = None):
        self._interval = float(interval_s)
        self._registry = registry or get_registry()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._interval <= 0 or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="device-telemetry", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            sample_device_telemetry(self._registry)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
