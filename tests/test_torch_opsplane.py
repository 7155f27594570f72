"""The telemetry and exit-code layer of the PyTorch port
(stoix_tpu_torch/observability, resilience/exit_codes.py) against the JAX
package's, on the same operations: the exit-code registry, the flight
record (the port's accepted by the JAX package's `validate_flight_record`,
the problems named alike), the Chrome trace (accepted by the JAX package's
`validate_chrome_trace`), the Prometheus text and the JSONL rows of the
same counter, gauge and histogram operations (identical), and the goodput
report of the same phases and clock (equal). Then the port's runs, as the
JAX tests pin them (tests/test_observability.py, tests/test_opsplane.py):
telemetry off records nothing and writes no file, telemetry on writes a
valid `trace.json`, `metrics.prom` and `metrics.jsonl`, and the HTTP ops
plane starts on its own switch (tests/test_torch_httpz.py holds it).
"""

import json
import math
import os
import sys
import threading

import pytest
import torch

from stoix_tpu.observability import exporters as jax_exporters
from stoix_tpu.observability import flightrec as jax_flightrec
from stoix_tpu.observability import goodput as jax_goodput
from stoix_tpu.observability import registry as jax_registry
from stoix_tpu.observability import trace_export as jax_trace_export
from stoix_tpu.resilience import exit_codes as jax_exit_codes
from stoix_tpu_torch import observability
from stoix_tpu_torch.observability import (
    exporters, flightrec, goodput, introspect, registry, trace, trace_export,
)
from stoix_tpu_torch.resilience import exit_codes
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
import torch_parity  # noqa: F401  (one torch thread)

TINY = ["env=identity_game", "arch.total_num_envs=8", "arch.num_updates=4",
        "arch.total_timesteps=~", "arch.num_evaluation=2", "arch.num_eval_episodes=4",
        "arch.absolute_metric=False", "system.rollout_length=4", "system.epochs=1",
        "system.num_minibatches=2", "logger.use_console=False"]


def test_exit_code_registry_equals_the_jax_package():
    assert exit_codes.REGISTRY == jax_exit_codes.REGISTRY
    assert (exit_codes.EXIT_CODE_STALL, exit_codes.EXIT_CODE_FLEET_PARTITION,
            exit_codes.EXIT_CODE_STATE_CORRUPTION, exit_codes.EXIT_CODE_ELASTIC_RESIZE) == (
        86, 87, 88, 89)


def test_flight_recorder_ring_and_dump_round_trip(tmp_path):
    recorder = flightrec.FlightRecorder(capacity=3)
    recorder.set_context(architecture="anakin", system="ff_ppo", seed=42)
    for window in range(5):
        recorder.record("window", window=window, wall_s=0.5)
    assert [e["window"] for e in recorder.events()] == [2, 3, 4]
    path = recorder.dump(str(tmp_path / "flight_record.json"), "unit", exit_code=88)
    record = json.load(open(path))
    assert jax_flightrec.validate_flight_record(record) == []
    assert record["context"] == {"architecture": "anakin", "system": "ff_ppo", "seed": 42}
    recorder.clear()
    assert recorder.events() == [] and not os.path.exists(path + f".tmp.{os.getpid()}")


@pytest.mark.parametrize("bad", [
    "nope",
    {"version": 2, "reason": "", "exit_code": "88", "context": [], "events": {}},
    {"version": 1, "reason": "r", "exit_code": None, "unix_time": 1.0, "context": {},
     "events": [{"seq": 2, "unix_time": 1.0, "kind": "w"}, {"seq": 2, "unix_time": "x"}, 3]},
])
def test_validate_flight_record_names_each_problem_as_the_jax_package(bad):
    assert flightrec.validate_flight_record(bad) == jax_flightrec.validate_flight_record(bad)


def test_dump_flight_record_default_dir_and_never_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    flightrec.get_flight_recorder().record("fault", fault="unit")
    path = flightrec.dump_flight_record(None, "unit", exit_code=86)
    assert path == os.path.join("checkpoints", flightrec.FLIGHT_RECORD_FILENAME)
    (tmp_path / "file").write_text("")
    assert flightrec.dump_flight_record(str(tmp_path / "file" / "sub"), "unit") is None


def test_chrome_trace_is_valid_for_the_jax_package_and_thread_aware(tmp_path):
    recorder = trace.TraceRecorder()
    assert isinstance(recorder.span("off"), trace._NoopSpan)  # disabled: the shared no-op
    recorder.enabled = True

    barrier = threading.Barrier(3)  # alive together: three thread idents

    def work(name):
        with recorder.span(name, window=1, obj=object()):
            barrier.wait(timeout=30)

    threads = [threading.Thread(target=work, args=(f"t{i}",), name=f"actor-{i}")
               for i in range(3)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    recorder.instant("marker")
    exported = trace_export.to_chrome_trace(recorder)
    assert jax_trace_export.validate_chrome_trace(exported) == []
    assert trace_export.validate_chrome_trace(exported) == []
    names = {e["args"]["name"] for e in exported["traceEvents"] if e["ph"] == "M"}
    assert {"actor-0", "actor-1", "actor-2"} <= names
    path = trace_export.write_chrome_trace(str(tmp_path / "t" / "trace.json"), recorder)
    assert jax_trace_export.validate_chrome_trace(json.load(open(path))) == []
    bounded = trace.TraceRecorder(max_events=2)
    bounded.enabled = True
    for _ in range(5):
        bounded.instant("x")
    assert bounded.event_count() == 2 and bounded.dropped == 3
    assert trace_export.to_chrome_trace(bounded)["metadata"] == {"dropped_events": 3}


def _same_operations(reg):
    c = reg.counter("stoix_tpu_unit_total", 'help with "quotes" and \\ backslash\nnewline')
    c.inc(2.5, {"phase": "learn"})
    c.inc(1.0, {"phase": 'we"ird\\val\nue'})
    c.inc(1.0, {"phase": "eval"})
    g = reg.gauge("stoix_tpu_unit_gauge", "a gauge")
    g.set(float("nan"), {"k": "nan"})
    g.set(float("inf"), {"k": "inf"})
    g.set(-3.25, {"k": "negative"})
    h = reg.histogram("stoix_tpu_unit_seconds", "latency")
    for value in (0.0001, 0.003, 0.2, 7.0, 500.0):
        h.observe(value, {"stage": "x"})
    h2 = reg.histogram("stoix_tpu_unit_custom_seconds", "", buckets=(1.0, 2.0))
    h2.observe(1.5)
    reg.counter("stoix_tpu_unit_labels_total").inc(1, {"bad label": "v", "0digit": "w"})


def test_prometheus_text_identical_to_the_jax_package():
    ours, theirs = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    _same_operations(ours)
    _same_operations(theirs)
    text = exporters.to_prometheus_text(ours)
    assert text == jax_exporters.to_prometheus_text(theirs)
    assert json.dumps(exporters.flatten_snapshot(ours.snapshot()), sort_keys=True) == (
        json.dumps(jax_exporters.flatten_snapshot(theirs.snapshot()), sort_keys=True))
    assert text.count("# TYPE stoix_tpu_unit_seconds histogram") == 1
    assert 'le="+Inf"' in text and "NaN" in text and 'bad_label="v"' in text
    # The names a registry could be handed, sanitised as the JAX package does.
    for name in ("stoix_tpu_ok_total", "rule:recorded:sum", "9leads-with.digit", "bad metric!",
                 ""):
        assert exporters.sanitize_metric_name(name) == jax_exporters.sanitize_metric_name(name)
        assert exporters.sanitize_label_name(name) == jax_exporters.sanitize_label_name(name)


def test_jsonl_writer_rows_equal_the_jax_package(tmp_path):
    rows = []
    for module, reg_module, name in ((exporters, registry, "port"),
                                     (jax_exporters, jax_registry, "jax")):
        reg = reg_module.MetricsRegistry()
        _same_operations(reg)
        writer = module.JsonlMetricsWriter(str(tmp_path / name / "metrics.jsonl"))
        writer.write_snapshot(7, reg)
        writer.close()
        row = json.loads(open(tmp_path / name / "metrics.jsonl").read())
        row.pop("time")
        rows.append(row)
    ours, theirs = rows
    assert ours["t"] == theirs["t"] == 7
    assert ours["metrics"].keys() == theirs["metrics"].keys()
    for key, value in ours["metrics"].items():
        other = theirs["metrics"][key]
        assert value == other or (math.isnan(value) and math.isnan(other)), key


def _ledger_report(module, reg_module):
    ledger = module.GoodputLedger(registry=reg_module.MetricsRegistry()).start()
    ledger.note_phases({"compile_s": 1.5, "learn_s": 2.0, "eval_s": 0.75, "ckpt_s": 0.25})
    ledger.note_phases({"rollout_get": 0.5, "assemble": 0.125, "learn": 1.0},
                       mapping=module.SEBULBA_PHASE_MAP)
    ledger.note("stall", 0.5)
    ledger.note("recovery", 0.375)
    with pytest.raises(ValueError):
        ledger.note("nope", 1.0)
    return ledger.finalize(wall_s=10.0)


def test_goodput_report_equals_the_jax_package_for_the_same_phases_and_clock():
    ours = _ledger_report(goodput, registry)
    assert ours == _ledger_report(jax_goodput, jax_registry)
    assert abs(sum(ours["fractions"].values()) - 1.0) < 1e-12
    assert goodput.disabled_report() == jax_goodput.disabled_report()
    # Over-attribution clamps to the attributed wall, as the JAX package's.
    over = [module.GoodputLedger(registry=reg.MetricsRegistry()) for module, reg in (
        (goodput, registry), (jax_goodput, jax_registry))]
    for ledger in over:
        ledger.note("eval", 3.0)
    assert over[0].finalize(wall_s=1.0) == over[1].finalize(wall_s=1.0)


def test_goodput_module_level_sites_charge_the_active_ledger():
    ledger = goodput.GoodputLedger(registry=registry.MetricsRegistry()).start()
    goodput.note_stall(1.0)  # no active ledger: nothing to charge
    goodput.set_active(ledger)
    try:
        goodput.note_stall(0.5)
        goodput.note_recovery(0.25)
    finally:
        goodput.set_active(None)
    assert ledger.seconds()["stall"] == 0.5 and ledger.seconds()["recovery"] == 0.25


def _run(extra):
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             "default/anakin/default_ff_ppo.yaml", TINY + list(extra))
    return ff_ppo.run_experiment(cfg, device="cpu")


def test_telemetry_off_keeps_last_run_stats_contract_and_records_nothing(tmp_path):
    before = trace.get_recorder().event_count()
    _run([f"logger.base_exp_path={tmp_path}"])
    assert not trace.is_enabled() and trace.get_recorder().event_count() == before
    assert not list(tmp_path.rglob("telemetry"))
    stats = runner.LAST_RUN_STATS
    assert {"phase_breakdown", "goodput", "integrity", "resilience"} <= set(stats)
    assert stats["preflight"] is None
    assert set(stats["goodput"]) == set(goodput.disabled_report())
    windows = [e for e in flightrec.get_flight_recorder().events() if e["kind"] == "window"]
    assert [e["window"] for e in windows] == [0, 1]  # the flight recorder is always on


def test_telemetry_on_writes_valid_trace_and_prometheus(tmp_path):
    _run([f"logger.base_exp_path={tmp_path}", "logger.telemetry.enabled=true",
          "logger.telemetry.device_poll_interval_s=0"])
    assert not trace.is_enabled()  # the sink's close shuts tracing down
    (directory,) = list(tmp_path.rglob("telemetry"))
    exported = json.load(open(directory / "trace.json"))
    assert jax_trace_export.validate_chrome_trace(exported) == []
    spans = {e["name"] for e in exported["traceEvents"] if e["ph"] == "X"}
    assert {"first_compile", "learn_dispatch", "eval_dispatch", "log"} <= spans
    text = (directory / "metrics.prom").read_text()
    assert "# TYPE stoix_tpu_goodput_seconds_total counter" in text
    assert "# TYPE stoix_tpu_learner_skipped_updates_total counter" in text
    rows = [json.loads(line) for line in open(directory / "metrics.jsonl")]
    assert len(rows) >= 6 and all("metrics" in row for row in rows)  # 3 events x 2 windows, +1


def test_http_ops_plane_stays_refused_naming_the_key(tmp_path):
    """The refusal this test pinned is lifted (tests/test_torch_httpz.py
    holds the plane against the JAX package's): `logger.telemetry.http.
    enabled` now starts the server, its own switch beside `enabled`, and the
    run records no span with telemetry off."""
    try:
        _run([f"logger.base_exp_path={tmp_path}", "logger.telemetry.http.enabled=true"])
        server = observability.get_ops_server()
        assert server is not None and server.port > 0
        assert not trace.is_enabled()
        assert observability.configure({"enabled": True, "http": {"enabled": True}}) is True
        assert observability.get_ops_server() is not server  # a fresh one a run
    finally:
        observability.shutdown()
    assert observability.get_ops_server() is None and not trace.is_enabled()


def test_device_poller_never_samples_a_cpu_run():
    reg = registry.MetricsRegistry()
    assert introspect.sample_device_telemetry(reg) == 0
    poller = introspect.DeviceTelemetryPoller(interval_s=0.0, registry=reg)
    poller.start()
    assert poller._thread is None
    poller.stop()


def test_device_poller_reads_only_cards_this_process_allocated_on(monkeypatch):
    """Two visible cards, allocations on card 1 only: `mem_get_info` (which
    makes a context on the card it asks) is asked of card 1 alone."""
    stats = {0: {"allocated_bytes.all.allocated": 0},
             1: {"allocated_bytes.all.allocated": 4096, "allocated_bytes.all.current": 1024,
                 "allocated_bytes.all.peak": 4096, "allocation.all.current": 2}}
    asked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device: stats[device])
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: asked.append(device) or (0, 80 << 30))
    reg = registry.MetricsRegistry()
    assert introspect.sample_device_telemetry(reg) == 4
    assert asked == [1]
    gauge = reg.gauge("stoix_tpu_device_memory_bytes")
    assert gauge.value({"device": "cuda:1", "kind": "bytes_in_use",
                        "source": "memory_stats"}) == 1024
    assert gauge.value({"device": "cuda:1", "kind": "bytes_limit",
                        "source": "mem_get_info"}) == 80 << 30


def test_sebulba_integrity_checks_at_eval_boundaries(tmp_path, monkeypatch):
    """Sebulba ff_ppo with the sentinel, preflight and telemetry on (the JAX
    package's tests/test_integrity.py::test_sebulba_integrity_checks_at_eval_boundaries).
    The port keeps one copy of the Sebulba learner state, so its check is the
    determinism probe: without one `arch.integrity` is refused, naming the
    key; with one, update 0 is replayed at each eval boundary (no verdict on
    a healthy run, with the goodput ledger and the flight recorder's
    windows), and wrong math in the replay is a `determinism` verdict."""
    from stoix_tpu_torch.resilience import integrity, preflight
    from stoix_tpu_torch.resilience.errors import StateCorruptionError
    from stoix_tpu_torch.systems.ppo.sebulba import ff_ppo as sebulba_ppo

    healthy = preflight.BackendProbe("cpu", "cpu", 1, 1, None, 1, 0.1)
    monkeypatch.setattr(preflight, "probe_backend", lambda **kwargs: healthy)
    monkeypatch.chdir(tmp_path)
    # A verdict keeps the sentinel's excepthook installed (exit code 88);
    # the test process gets its own back.
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)

    def compose(*extra):
        return config_lib.compose(config_lib.default_config_dir(),
                                  "default/sebulba/default_ff_ppo.yaml", [
            "env=identity_game", "arch.total_num_envs=8", "arch.total_timesteps=1024",
            "arch.num_evaluation=2", "arch.num_eval_episodes=4", "system.rollout_length=8",
            "system.num_minibatches=2", "logger.use_console=False", "arch.actor.device_ids=[0]",
            "arch.learner.device_ids=[0]", "arch.evaluator_device_id=0",
            "arch.integrity.enabled=true", "arch.preflight.enabled=true",
            "logger.telemetry.enabled=true", "logger.telemetry.device_poll_interval_s=0",
            f"logger.base_exp_path={tmp_path}", *extra])

    with pytest.raises(NotImplementedError,
                       match=r"arch\.integrity\.determinism_probe_interval > 0"):
        sebulba_ppo.run_experiment(compose(), device="cpu")
    probe = compose("arch.integrity.determinism_probe_interval=1")
    assert math.isfinite(sebulba_ppo.run_experiment(probe, device="cpu"))
    stats = sebulba_ppo.LAST_RUN_STATS
    assert stats["integrity"]["probe_runs"] == 2 and stats["integrity"]["enabled"]
    assert stats["resilience"]["preempted"] is False
    assert abs(sum(stats["goodput"]["fractions"].values()) - 1.0) < 1e-9
    assert stats["goodput"]["seconds"]["queue_wait"] > 0
    windows = [e for e in flightrec.get_flight_recorder().events() if e["kind"] == "window"]
    assert [e["window"] for e in windows] == [1, 2]
    (directory,) = list(tmp_path.rglob("telemetry"))
    assert jax_trace_export.validate_chrome_trace(
        json.load(open(directory / "trace.json"))) == []

    replay = integrity.StateIntegritySentinel.run_probe

    def wrong_math_on_replay(self, learn_fn):
        def perturbed(held):
            state = learn_fn(held)
            actor = dict(state.params.actor_params)
            key = next(iter(actor))
            actor[key] = actor[key] * (1.0 + 2 ** -20)
            return state._replace(params=state.params._replace(actor_params=actor))

        return replay(self, perturbed)

    monkeypatch.setattr(integrity.StateIntegritySentinel, "run_probe", wrong_math_on_replay)
    with pytest.raises(StateCorruptionError) as excinfo:
        sebulba_ppo.run_experiment(probe, device="cpu")
    assert excinfo.value.kind == "determinism" and excinfo.value.groups == ["params"]
