"""Per-process ops endpoints: /metrics, /metrics/fleet, /healthz, /statusz,
/varz (counterpart of stoix_tpu/observability/httpz.py: the same routes,
pages and status codes).

A standard-library `ThreadingHTTPServer` on a daemon thread, started by
`observability.configure()` when `logger.telemetry.http.enabled` is true
(off by default: no socket, no thread). Routes:

  /metrics        live Prometheus text from the process registry
                  (`exporters.to_prometheus_text`, the bytes of the file the
                  TelemetrySink writes)
  /metrics/fleet  the fleet-wide view with a `host` label on every series,
                  when a FleetMetricsAggregator is attached (aggregate.py);
                  404 otherwise
  /healthz        the HealthMonitor's verdict (heartbeat boards, stall
                  thresholds, the watchdog): 200 ok, 503 with the detail
  /statusz        a one-page run status (StatusBoard plus the registry's
                  phase, goodput, fleet, IMPACT and replay series, the
                  restore report and the quarantine record)
  /varz           the same as JSON ({"status": ..., "metrics": flat registry})

Requests read point-in-time snapshots (the registry copies under its own
locks); nothing on the training path waits on this server, and it never
touches a device. `close()` shuts the socket down and joins the thread.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

from stoix_tpu_torch.observability import flightrec
from stoix_tpu_torch.observability.exporters import flatten_snapshot, to_prometheus_text
from stoix_tpu_torch.observability.health import HealthMonitor, get_health_monitor
from stoix_tpu_torch.observability.registry import MetricsRegistry, get_registry


class StatusBoard:
    """Thread-safe run-status fields for /statusz and /varz. Producers
    (runner, Sebulba learner, serve) set plain values; `register_provider`
    attaches a zero-arg callable evaluated at render time (the serve SLO
    ladder stays live without the server pushing on every request)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._fields: Dict[str, Any] = {}
        self._providers: Dict[str, Callable[[], Any]] = {}

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            self._fields[key] = value

    def update(self, fields: Dict[str, Any]) -> None:
        with self._lock:
            self._fields.update(fields)

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._fields.get(key, default)

    def register_provider(self, key: str, provider: Callable[[], Any]) -> None:
        with self._lock:
            self._providers[key] = provider

    def unregister_provider(self, key: str) -> None:
        with self._lock:
            self._providers.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._fields.clear()
            self._providers.clear()

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            fields = dict(self._fields)
            providers = dict(self._providers)
        for key, provider in providers.items():
            try:
                fields[key] = provider()
            except Exception as err:  # noqa: BLE001 — a broken provider must
                # not take down the status page reporting everything else.
                fields[key] = f"<provider error: {err!r}>"
        return fields


_board_lock = threading.Lock()
_status_board: Optional[StatusBoard] = None


def get_status_board() -> StatusBoard:
    global _status_board
    with _board_lock:
        if _status_board is None:
            _status_board = StatusBoard()
        return _status_board


def _section(title: str, rows: Dict[str, Any]) -> str:
    lines = [f"== {title} =="]
    for key, value in rows.items():
        lines.append(f"  {key:<28} {value}")
    return "\n".join(lines)


def render_statusz(
    status: StatusBoard, registry: Optional[MetricsRegistry] = None
) -> str:
    """One text page: everything an operator curls first. Pulls the status
    board (run identity, window/step, restore report) and derives the rest
    from the live registry snapshot so the page needs no extra bookkeeping
    on the hot path."""
    registry = registry or get_registry()
    fields = status.as_dict()
    flat = flatten_snapshot(registry.snapshot())
    page = [
        "stoix_tpu statusz",
        time.strftime("%Y-%m-%d %H:%M:%S %z"),
        "",
    ]

    run_rows = {
        key: fields[key]
        for key in ("run_id", "architecture", "system", "env")
        if key in fields
    }
    run_rows.update(
        {
            key: fields[key]
            for key in ("window", "step", "steps_per_second")
            if key in fields
        }
    )
    page.append(_section("run", run_rows or {"state": "no run registered"}))

    phase_rows = {
        key.split("phase=", 1)[1].rstrip("}"): f"{value:.3f}s"
        for key, value in sorted(flat.items())
        if key.startswith("stoix_tpu_runner_phase_seconds_total{")
    }
    if phase_rows:
        page.append(_section("phase breakdown (cumulative)", phase_rows))

    goodput_rows = {
        key.split("phase=", 1)[1].rstrip("}"): f"{value:.3f}s"
        for key, value in sorted(flat.items())
        if key.startswith("stoix_tpu_goodput_seconds_total{")
    }
    if "stoix_tpu_goodput_fraction" in flat:
        goodput_rows["goodput_fraction"] = f"{flat['stoix_tpu_goodput_fraction']:.4f}"
    if goodput_rows:
        page.append(_section("goodput ledger", goodput_rows))

    fleet_rows = {
        key[len("stoix_tpu_fleet_"):]: value
        for key, value in sorted(flat.items())
        if key.startswith("stoix_tpu_fleet_")
    }
    if fleet_rows:
        page.append(_section("fleet (skew / heartbeats)", fleet_rows))

    impact_rows = {
        key[len("stoix_tpu_impact_"):]: value
        for key, value in sorted(flat.items())
        if key.startswith("stoix_tpu_impact_")
    }
    if impact_rows:
        page.append(_section("impact staleness", impact_rows))

    replay_rows = {
        key[len("stoix_tpu_replay_"):]: value
        for key, value in sorted(flat.items())
        if key.startswith("stoix_tpu_replay_")
    }
    if replay_rows:
        page.append(_section("replay occupancy", replay_rows))

    resilience_rows: Dict[str, Any] = {}
    if "restore_skipped" in fields:
        resilience_rows["restore_skipped"] = fields["restore_skipped"]
    restore_report = fields.get("last_restore_report")
    if restore_report:
        for i, entry in enumerate(restore_report):
            resilience_rows[f"restore_report[{i}]"] = entry
    quarantine_file = fields.get("quarantine_file")
    if quarantine_file and os.path.exists(str(quarantine_file)):
        resilience_rows["quarantine_record"] = quarantine_file
    if resilience_rows:
        page.append(_section("resilience", resilience_rows))

    serve_slo = fields.get("serve_slo")
    if isinstance(serve_slo, dict):
        page.append(
            _section("serve SLO ladder", {k: serve_slo[k] for k in sorted(serve_slo)})
        )

    events = flightrec.get_flight_recorder().events()
    if events:
        last = events[-1]
        page.append(
            _section(
                "flight recorder",
                {
                    "events_buffered": len(events),
                    "last_event": f"{last.get('kind')} (seq {last.get('seq')})",
                },
            )
        )
    return "\n\n".join(page) + "\n"


class _OpsHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # Set by OpsServer.start(); the handler reaches its owner through the
    # server instance http.server passes it.
    ops: "OpsServer"


class _Handler(BaseHTTPRequestHandler):
    server: _OpsHTTPServer

    def _respond(self, code: int, body: str, content_type: str) -> None:
        payload = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:  # noqa: N802 — http.server API name
        ops = self.server.ops
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            route = ops.routes.get(path)
            if route is None:
                self._respond(
                    404,
                    "not found; endpoints: " + ", ".join(sorted(ops.routes)) + "\n",
                    "text/plain; charset=utf-8",
                )
                return
            code, body, content_type = route()
            self._respond(code, body, content_type)
        except BrokenPipeError:
            pass  # client hung up mid-response; nothing to answer
        except Exception as err:  # noqa: BLE001 — an endpoint bug must return
            # 500 to the scraper, never kill the handler thread with a
            # traceback dump to stderr on every poll.
            try:
                self._respond(500, f"internal error: {err!r}\n",
                              "text/plain; charset=utf-8")
            except OSError:
                pass

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        # Route http.server's per-request stderr lines to debug logging:
        # a 1 Hz scraper must not spam an interactive run's console.
        logging.getLogger("stoix_tpu_torch.httpz").debug(format, *args)


class OpsServer:
    """The per-process ops-plane HTTP server. `start()` binds (port 0 picks
    an ephemeral port — read `.port` after start) and serves from a daemon
    thread; `close()` shuts the socket down and joins the thread."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        registry: Optional[MetricsRegistry] = None,
        monitor: Optional[HealthMonitor] = None,
        status: Optional[StatusBoard] = None,
    ):
        self._host = host
        self._port = int(port)
        self._registry = registry or get_registry()
        self._monitor = monitor or get_health_monitor()
        self._status = status or get_status_board()
        self._server: Optional[_OpsHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._aggregator: Optional[Any] = None
        self.routes: Dict[str, Callable[[], Tuple[int, str, str]]] = {
            "/metrics": self._metrics,
            "/metrics/fleet": self._metrics_fleet,
            "/healthz": self._healthz,
            "/statusz": self._statusz,
            "/varz": self._varz,
        }

    def set_aggregator(self, aggregator: Optional[Any]) -> None:
        """Attach/detach the fleet metrics aggregator serving /metrics/fleet
        (aggregate.py — created per run when fleet coordination is on)."""
        self._aggregator = aggregator

    def _metrics(self) -> Tuple[int, str, str]:
        return (
            200,
            to_prometheus_text(self._registry),
            "text/plain; version=0.0.4; charset=utf-8",
        )

    def _metrics_fleet(self) -> Tuple[int, str, str]:
        aggregator = self._aggregator
        if aggregator is None:
            return (
                404,
                "no fleet aggregator attached (single-host run, or "
                "arch.fleet.enabled=false)\n",
                "text/plain; charset=utf-8",
            )
        return (
            200,
            aggregator.render(),
            "text/plain; version=0.0.4; charset=utf-8",
        )

    def _healthz(self) -> Tuple[int, str, str]:
        healthy, detail = self._monitor.verdict()
        return (200 if healthy else 503, detail + "\n", "text/plain; charset=utf-8")

    def _statusz(self) -> Tuple[int, str, str]:
        return (
            200,
            render_statusz(self._status, self._registry),
            "text/plain; charset=utf-8",
        )

    def _varz(self) -> Tuple[int, str, str]:
        healthy, detail = self._monitor.verdict()
        body = json.dumps(
            {
                "status": self._status.as_dict(),
                "healthy": healthy,
                "health_detail": detail,
                "metrics": flatten_snapshot(self._registry.snapshot()),
            },
            default=str,
            indent=2,
        )
        return 200, body + "\n", "application/json"

    def start(self) -> "OpsServer":
        if self._server is not None:
            return self
        server = _OpsHTTPServer((self._host, self._port), _Handler)
        server.ops = self
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever,
            name="stoix-tpu-torch-httpz",
            daemon=True,
        )
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        if self._server is not None:
            return self._server.server_address[1]
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def close(self, join_timeout: float = 5.0) -> None:
        server, thread = self._server, self._thread
        self._server, self._thread = None, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(join_timeout)


def server_from_config(http_cfg: Any) -> Optional[OpsServer]:
    """Build + start an OpsServer from a `logger.telemetry.http` block
    (plain/Config dict or None). Returns None when disabled — the off path
    creates no socket and no thread."""
    cfg = dict(http_cfg or {})
    if not bool(cfg.get("enabled", False)):
        return None
    server = OpsServer(
        host=str(cfg.get("host") or "127.0.0.1"),
        port=int(cfg.get("port") or 0),
    ).start()
    logging.getLogger("stoix_tpu_torch.httpz").info(
        "[httpz] ops endpoints live at %s/{metrics,healthz,statusz,varz}",
        server.url,
    )
    return server
