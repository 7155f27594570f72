"""Telemetry of the port (counterpart of stoix_tpu/observability): the
process-wide metrics registry and its exporters (Prometheus text, JSONL),
host span tracing and its Chrome-trace export, the crash flight recorder,
the goodput ledger, the device poller, and Sebulba's heartbeats and stall
detector.

`configure(cfg.logger.telemetry)` is the single switch, called by
StoixLogger once a run. Disabled (the default) spans are shared no-op
context managers, no poller thread starts and no file is written. It is
also the per-run reset: every run starts with a fresh flight-recorder ring
(a crash dump covers this run's windows) and, with telemetry on, a fresh
span buffer. Every instrument is host memory only: a run's trajectory is
the same bits with telemetry on or off. The HTTP ops plane
(`logger.telemetry.http`) is not ported (ROADMAP A19b) and raises.
"""

from __future__ import annotations

import logging
import sys
import threading
from typing import Any, Optional

from stoix_tpu_torch.observability.exporters import (
    JsonlMetricsWriter,
    flatten_snapshot,
    to_prometheus_text,
    write_prometheus,
)
from stoix_tpu_torch.observability.flightrec import (
    FlightRecorder,
    dump_flight_record,
    get_flight_recorder,
    validate_flight_record,
)
from stoix_tpu_torch.observability.goodput import GoodputLedger
from stoix_tpu_torch.observability.health import (
    ActorStarvationError,
    HeartbeatBoard,
    StallDetector,
)
from stoix_tpu_torch.observability.introspect import (
    DeviceTelemetryPoller,
    sample_device_telemetry,
)
from stoix_tpu_torch.observability.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RunStats,
    get_registry,
)
from stoix_tpu_torch.observability.trace import (
    annotate,
    device_annotation,
    get_recorder,
    instant,
    is_enabled,
    set_enabled,
    span,
)
from stoix_tpu_torch.observability.trace_export import (
    to_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)

__all__ = [
    "ActorStarvationError", "Counter", "DeviceTelemetryPoller", "FlightRecorder", "Gauge",
    "GoodputLedger", "HeartbeatBoard", "Histogram", "JsonlMetricsWriter", "MetricsRegistry",
    "RunStats", "StallDetector", "annotate", "configure", "device_annotation",
    "dump_flight_record", "flatten_snapshot", "get_flight_recorder", "get_logger",
    "get_recorder", "get_registry", "instant", "is_enabled", "sample_device_telemetry",
    "set_enabled", "shutdown", "span", "to_chrome_trace", "to_prometheus_text",
    "validate_chrome_trace", "validate_flight_record", "write_chrome_trace", "write_prometheus",
]

_lock = threading.Lock()
_poller: Optional[DeviceTelemetryPoller] = None


def get_logger(name: str = "stoix_tpu_torch") -> logging.Logger:
    """The package's status-line logger. Defers to the application's logging
    config when one exists; with no handler anywhere, attaches a
    message-only stderr handler at INFO."""
    root = logging.getLogger("stoix_tpu_torch")
    with _lock:
        if not root.handlers and not logging.getLogger().handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter("%(message)s"))
            root.addHandler(handler)
            root.setLevel(logging.INFO)
            root.propagate = False
    return logging.getLogger(name)


def configure(telemetry_cfg: Any = None) -> bool:
    """Apply a `logger.telemetry` block (a dict or None); returns whether
    telemetry is on. Resets the flight recorder; with telemetry on, clears
    the span buffer, turns span recording on and starts the device poller
    (`device_poll_interval_s`, <= 0 for none) after one synchronous sample.
    `http.enabled` raises NotImplementedError, naming the key."""
    cfg = telemetry_cfg or {}
    if (cfg.get("http") or {}).get("enabled", False):
        raise NotImplementedError(
            "not ported: logger.telemetry.http.enabled (the HTTP ops plane, ROADMAP A19b)")
    enabled = bool(cfg.get("enabled", False))
    global _poller
    with _lock:
        set_enabled(enabled)
        if _poller is not None:
            _poller.stop()
            _poller = None
        get_flight_recorder().clear()
        if enabled:
            get_recorder().clear()
            interval = float(cfg.get("device_poll_interval_s", 5.0) or 0.0)
            if interval > 0:
                _poller = DeviceTelemetryPoller(interval_s=interval)
                _poller.start()
            sample_device_telemetry()
    return enabled


def shutdown() -> None:
    """Stop the poller and turn span recording off (the buffer and the
    registry keep their contents for export)."""
    global _poller
    with _lock:
        if _poller is not None:
            _poller.stop()
            _poller = None
        set_enabled(False)
