"""The HTTP ops plane of the PyTorch port (stoix_tpu_torch/observability:
httpz.py, aggregate.py and health.py's HealthMonitor) against the JAX
package's, on the same inputs: `render_statusz` (identical text for the same
board, registry and restore report), `encode_snapshot`/`decode_snapshot`
(round trip) and `render_fleet_text` (identical text for the same
snapshots; a torn blob skipped). Then the port's live server, as
tests/test_opsplane.py pins the JAX one's: `/metrics` is the registry's
text, `/varz` and `/statusz` serve the board, `/healthz` goes from 200 to
503 when a board goes stale, `/metrics/fleet` folds every process; the
configure lifecycle, a bind failure raising, a run's fresh health monitor;
and the Anakin and Sebulba runners serving while they run.
"""

import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from stoix_tpu.observability import aggregate as jax_aggregate
from stoix_tpu.observability import flightrec as jax_flightrec
from stoix_tpu.observability import httpz as jax_httpz
from stoix_tpu.observability import registry as jax_registry
from stoix_tpu_torch import observability as obs
from stoix_tpu_torch.observability import (
    FleetMetricsAggregator, HeartbeatBoard, MetricsRegistry, OpsServer, StatusBoard, exporters,
    flightrec, get_health_monitor, get_registry, get_status_board, render_statusz,
    server_from_config,
)
from stoix_tpu_torch.observability.aggregate import (
    decode_snapshot, encode_snapshot, render_fleet_text,
)
from stoix_tpu_torch.resilience import faultinject, fleet
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.ppo.sebulba import ff_ppo as sebulba_ppo
from stoix_tpu_torch.utils import config as config_lib
import torch_fleet_worker as worker
import torch_parity  # noqa: F401  (one torch thread)

_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$')


def _reset():
    faultinject.reset()
    obs.shutdown()
    get_health_monitor().reset()
    get_status_board().clear()
    flightrec.get_flight_recorder().clear()


@pytest.fixture(autouse=True)
def _ops_plane_isolation():
    _reset()
    yield
    _reset()


def _http_get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as response:
            return response.status, response.read().decode(), response.headers["Content-Type"]
    except urllib.error.HTTPError as error:
        return error.code, error.read().decode(), error.headers["Content-Type"]


def _same_registries():
    """The same operations on a port registry and a JAX one."""
    ours, theirs = MetricsRegistry(), jax_registry.MetricsRegistry()
    for reg in (ours, theirs):
        reg.counter("stoix_tpu_runner_phase_seconds_total", "phases").inc(1.25, {"phase": "learn"})
        reg.counter("stoix_tpu_goodput_seconds_total", "goodput").inc(3.0, {"phase": "compute"})
        reg.gauge("stoix_tpu_goodput_fraction", "fraction").set(0.875)
        reg.gauge("stoix_tpu_fleet_window_skew_ratio", "skew").set(1.5)
        reg.gauge("stoix_tpu_fleet_window_wall_seconds", "walls").set(2.0, {"process": "1"})
        reg.gauge("stoix_tpu_impact_batch_staleness", "staleness").set(2)
        reg.counter("stoix_tpu_replay_items_total", "replay").inc(64)
        reg.histogram("stoix_tpu_unit_httpz_seconds", "h", buckets=(0.1, 1.0)).observe(
            0.5, {"k": "v"})
    return ours, theirs


# ------------------------------------------------------------ against the JAX package


@pytest.mark.parametrize("quarantined", [False, True])
def test_render_statusz_equals_the_jax_package(quarantined, tmp_path, monkeypatch):
    ours_reg, theirs_reg = _same_registries()
    quarantine = tmp_path / "quarantine.json"
    if quarantined:
        quarantine.write_text("{}")
    fields = {"run_id": "ff_ppo_seed42", "architecture": "anakin", "system": "ff_ppo",
              "window": 3, "step": 4096, "steps_per_second": 1234.5, "restore_skipped": 2,
              "last_restore_report": [{"step": "500", "reason": "digest", "error": "x"}],
              "quarantine_file": str(quarantine), "serve_slo": {"p99_ms": 4.2, "shed": 0}}
    ours, theirs = StatusBoard(), jax_httpz.StatusBoard()
    ours.update(fields)
    theirs.update(fields)
    for recorder in (flightrec.get_flight_recorder(), jax_flightrec.get_flight_recorder()):
        recorder.clear()
        recorder.record("window", window=3)
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "2026-01-01 00:00:00 +0000")
    try:
        page = render_statusz(ours, ours_reg)
        assert page == jax_httpz.render_statusz(theirs, theirs_reg)
    finally:
        jax_flightrec.get_flight_recorder().clear()
    for section in ("== run ==", "phase breakdown", "goodput ledger", "fleet (skew",
                    "impact staleness", "replay occupancy", "restore_report[0]",
                    "serve SLO ladder", "flight recorder"):
        assert section in page
    assert ("quarantine_record" in page) is quarantined


def test_fleet_text_and_snapshot_encoding_equal_the_jax_package():
    ours_reg, theirs_reg = _same_registries()
    blob = encode_snapshot(ours_reg.snapshot())
    assert blob == jax_aggregate.encode_snapshot(theirs_reg.snapshot())
    decoded = decode_snapshot(blob)
    assert decoded == jax_aggregate.decode_snapshot(blob)
    assert decoded["stoix_tpu_unit_httpz_seconds"]["series"][0]["buckets"][float("inf")] == 1
    snapshots = {0: decoded, 1: decode_snapshot(encode_snapshot(MetricsRegistry().snapshot())),
                 3: decoded}
    text = render_fleet_text(snapshots)
    assert text == jax_aggregate.render_fleet_text(snapshots)
    assert 'stoix_tpu_goodput_fraction{host="3"} 0.875' in text
    assert all(_SAMPLE.match(line) for line in text.splitlines() if not line.startswith("#"))


def test_fleet_aggregator_folds_hosts_with_labels_and_skips_torn_blobs():
    store = fleet.FakeFleetStore(2)
    reg0, reg1 = MetricsRegistry(), MetricsRegistry()
    reg0.counter("stoix_tpu_unit_fleet_total", "fold unit").inc(1.0)
    reg1.counter("stoix_tpu_unit_fleet_total", "fold unit").inc(2.0)
    reg1.histogram("stoix_tpu_unit_fleet_seconds", buckets=(0.1, 1.0)).observe(0.5)
    agg0 = FleetMetricsAggregator(store.view(0), 0, 2, registry=reg0, interval_s=60.0)
    agg1 = FleetMetricsAggregator(store.view(1), 1, 2, registry=reg1, interval_s=60.0)
    agg1.publish_once()
    text = agg0.render()
    assert 'stoix_tpu_unit_fleet_total{host="0"} 1.0' in text
    assert 'stoix_tpu_unit_fleet_total{host="1"} 2.0' in text
    assert 'stoix_tpu_unit_fleet_seconds_bucket{host="1",le="+Inf"} 1' in text
    assert text.count("# TYPE stoix_tpu_unit_fleet_total") == 1
    store.put("ometrics/1", "{definitely not json")
    text = agg0.render()
    assert 'host="0"' in text and 'host="1"' not in text
    server = OpsServer().start()
    try:
        server.set_aggregator(agg0)
        code, body, ctype = _http_get(server.port, "/metrics/fleet")
        assert code == 200 and "version=0.0.4" in ctype
        assert 'stoix_tpu_unit_fleet_total{host="0"} 1.0' in body
    finally:
        server.close()
        agg0.close()
        agg1.close()


# ------------------------------------------------------------ the live server


def test_ops_server_serves_registry_status_and_varz():
    get_registry().counter("stoix_tpu_unit_opsplane_total", "ops server unit sentinel").inc(7.0)
    get_status_board().update({"run_id": "unit_run", "architecture": "anakin"})
    server = OpsServer().start()
    try:
        assert server.port > 0
        code, body, ctype = _http_get(server.port, "/metrics")
        assert code == 200 and ctype == "text/plain; version=0.0.4; charset=utf-8"
        assert body == exporters.to_prometheus_text(get_registry())
        assert _http_get(server.port, "/metrics/?x=1")[0] == 200
        code, body, ctype = _http_get(server.port, "/varz")
        varz = json.loads(body)
        assert code == 200 and ctype == "application/json"
        assert varz["status"]["run_id"] == "unit_run" and varz["healthy"] is True
        assert varz["metrics"] == exporters.flatten_snapshot(get_registry().snapshot())
        code, body, _ = _http_get(server.port, "/statusz")
        assert code == 200 and "unit_run" in body
        code, body, _ = _http_get(server.port, "/metrics/fleet")
        assert code == 404 and "aggregator" in body
        code, body, _ = _http_get(server.port, "/nosuch")
        assert code == 404 and all(e in body for e in ("/metrics", "/healthz", "/statusz", "/varz"))
    finally:
        server.close()


def test_healthz_flips_to_503_when_a_board_goes_stale():
    monitor = get_health_monitor()
    board = HeartbeatBoard(registry=MetricsRegistry())
    monitor.register_board("unit-loop", board, stale_after_s=0.15)
    server = OpsServer().start()
    try:
        assert _http_get(server.port, "/healthz")[0] == 200  # never beaten is healthy
        board.beat("window")
        assert _http_get(server.port, "/healthz")[0] == 200
        time.sleep(0.35)
        code, body, _ = _http_get(server.port, "/healthz")
        assert code == 503 and "unit-loop" in body
        board.beat("window")
        assert _http_get(server.port, "/healthz")[0] == 200
        monitor.register_check("unit-check", lambda: "dead component")
        code, body, _ = _http_get(server.port, "/healthz")
        assert code == 503 and "unit-check: dead component" in body
    finally:
        server.close()
        monitor.unregister("unit-loop")
        monitor.unregister("unit-check")


def test_server_from_config_and_configure_lifecycle():
    assert server_from_config(None) is None and server_from_config({"enabled": False}) is None
    assert obs.configure({"http": {"enabled": True, "port": 0}}) is False
    server = obs.get_ops_server()
    assert server is not None and _http_get(server.port, "/healthz")[0] == 200
    obs.configure({})
    assert obs.get_ops_server() is None
    obs.configure({"http": {"enabled": True}})
    assert obs.get_ops_server() is not None
    obs.shutdown()
    assert obs.get_ops_server() is None


def test_an_http_bind_failure_raises():
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    try:
        with pytest.raises(OSError):
            obs.configure({"http": {"enabled": True, "port": taken.getsockname()[1]}})
    finally:
        taken.close()


def test_each_run_gets_a_fresh_health_monitor():
    monitor = get_health_monitor()
    stale = HeartbeatBoard(registry=MetricsRegistry())
    stale.beat("window")
    time.sleep(0.05)
    monitor.register_board("previous-run", stale, stale_after_s=0.01)
    get_registry().counter("stoix_tpu_watchdog_stalls_total", "Watchdog deadlines blown, by stage"
                           ).inc(labels={"stage": "unit-previous-run"})
    assert monitor.verdict()[0] is False
    obs.configure({})
    healthy, detail = get_health_monitor().verdict()
    assert healthy is True, detail


# ------------------------------------------------------------ the runners


def _scrape_while(run, port_of):
    """Run `run()` while a thread scrapes /healthz and /metrics of the
    server `port_of()` returns once it is up; returns what it saw."""
    seen = {"healthz": [], "metrics": 0}
    done = threading.Event()

    def scrape():
        while not done.is_set():
            port = port_of()
            if port is not None:
                seen["healthz"].append(_http_get(port, "/healthz")[0])
                seen["metrics"] += _http_get(port, "/metrics")[0] == 200
            time.sleep(0.05)

    thread = threading.Thread(target=scrape, daemon=True)
    thread.start()
    try:
        run()
    finally:
        done.set()
        thread.join(timeout=10)
    return seen


def _port():
    server = obs.get_ops_server()
    return None if server is None else server.port


def test_anakin_serves_while_it_runs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/anakin/default_ff_ppo.yaml", worker.TINY + [
        "arch.num_evaluation=3", "arch.total_timesteps=192", "logger.telemetry.http.enabled=true"])
    seen = _scrape_while(lambda: ff_ppo.run_experiment(config, device="cpu"), _port)
    assert seen["metrics"] > 0 and set(seen["healthz"]) == {200}
    page = _http_get(_port(), "/statusz")[1]
    assert "ff_ppo_seed42" in page and "anakin" in page
    assert get_status_board().get("step") == 192
    assert "anakin-host-loop" not in get_health_monitor().verdict()[1]  # unregistered at the end


@pytest.mark.parametrize("system", ["ff_ppo", "ff_dqn"])
def test_sebulba_serves_while_it_runs(system, tmp_path, monkeypatch):
    from stoix_tpu_torch.systems.q_learning.sebulba import ff_dqn

    monkeypatch.chdir(tmp_path)
    module = sebulba_ppo if system == "ff_ppo" else ff_dqn
    extra = ([] if system == "ff_ppo" else
             ["system.total_buffer_size=1024", "system.total_batch_size=32",
              "system.replay.min_fill=64"])
    config = config_lib.compose(config_lib.default_config_dir(),
                                f"default/sebulba/default_{system}.yaml", worker.SEBULBA_TINY + [
        "arch.total_timesteps=1024", "arch.num_evaluation=2",
        "logger.telemetry.http.enabled=true", *extra])
    seen = _scrape_while(lambda: module.run_experiment(config, device="cpu"), _port)
    assert seen["metrics"] > 0 and set(seen["healthz"]) == {200}
    assert get_status_board().get("architecture") == "sebulba"
    assert get_status_board().get("window") == 2
