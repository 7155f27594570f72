"""Telemetry of the port (counterpart of stoix_tpu/observability): the
process-wide metrics registry and its exporters (Prometheus text, JSONL),
host span tracing and its Chrome-trace export, the crash flight recorder,
the goodput ledger, the device poller, heartbeats with the stall detector
and the health monitor, and the HTTP ops plane (httpz.py: the status board
and the /metrics, /metrics/fleet, /healthz, /statusz and /varz server; the
fleet-wide metrics of aggregate.py).

`configure(cfg.logger.telemetry)` is the single switch, called by
StoixLogger once a run. Disabled (the default) spans are shared no-op
context managers, no poller thread starts and no file is written. It is
also the per-run reset: every run starts with a fresh flight-recorder ring
(a crash dump covers this run's windows) and, with telemetry on, a fresh
span buffer. Every instrument is host memory only: a run's trajectory is
the same bits with telemetry on or off. Every run also gets a fresh
HealthMonitor (no board of an earlier run can turn /healthz to 503), and
`logger.telemetry.http.enabled` starts the ops server, its own switch:
`get_ops_server()` returns it (None when off: no socket, no thread).
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
from stoix_tpu_torch.observability.aggregate import (
    FleetMetricsAggregator,
    aggregator_from_fleet,
)
from stoix_tpu_torch.observability.health import (
    ActorStarvationError,
    HealthMonitor,
    HeartbeatBoard,
    StallDetector,
    get_health_monitor,
)
from stoix_tpu_torch.observability.httpz import (
    OpsServer,
    StatusBoard,
    get_status_board,
    render_statusz,
    server_from_config,
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
    "ActorStarvationError", "Counter", "DeviceTelemetryPoller", "FleetMetricsAggregator",
    "FlightRecorder", "Gauge", "GoodputLedger", "HealthMonitor", "HeartbeatBoard", "Histogram",
    "JsonlMetricsWriter", "MetricsRegistry", "OpsServer", "RunStats", "StallDetector",
    "StatusBoard", "aggregator_from_fleet", "annotate", "configure", "device_annotation",
    "dump_flight_record", "flatten_snapshot", "get_flight_recorder", "get_health_monitor",
    "get_logger", "get_ops_server", "get_recorder", "get_registry", "get_status_board",
    "instant", "is_enabled", "render_statusz", "sample_device_telemetry", "server_from_config",
    "set_enabled", "shutdown", "span", "to_chrome_trace", "to_prometheus_text",
    "validate_chrome_trace", "validate_flight_record", "write_chrome_trace", "write_prometheus",
]

_lock = threading.Lock()
_poller: Optional[DeviceTelemetryPoller] = None
_http_server: Optional[OpsServer] = None


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
    telemetry is on. Resets the flight recorder and the health monitor and
    replaces the ops server (`http.enabled`: started, else none); with
    telemetry on, clears the span buffer, turns span recording on and starts
    the device poller (`device_poll_interval_s`, <= 0 for none) after one
    synchronous sample. An HTTP bind failure raises."""
    cfg = telemetry_cfg or {}
    enabled = bool(cfg.get("enabled", False))
    global _poller, _http_server
    with _lock:
        set_enabled(enabled)
        if _poller is not None:
            _poller.stop()
            _poller = None
        if _http_server is not None:
            _http_server.close()
            _http_server = None
        get_health_monitor().reset()
        get_flight_recorder().clear()
        _http_server = server_from_config(cfg.get("http"))
        if enabled:
            get_recorder().clear()
            interval = float(cfg.get("device_poll_interval_s", 5.0) or 0.0)
            if interval > 0:
                _poller = DeviceTelemetryPoller(interval_s=interval)
                _poller.start()
            sample_device_telemetry()
    return enabled


def shutdown() -> None:
    """Stop the poller and the ops server and turn span recording off (the
    buffer and the registry keep their contents for export)."""
    global _poller, _http_server
    with _lock:
        if _poller is not None:
            _poller.stop()
            _poller = None
        if _http_server is not None:
            _http_server.close()
            _http_server = None
        set_enabled(False)


def get_ops_server() -> Optional[OpsServer]:
    """The live OpsServer that configure() started, or None when
    `logger.telemetry.http.enabled` is off; the runner attaches the fleet
    aggregator through it, and a caller reads its port (`.port`)."""
    with _lock:
        return _http_server
