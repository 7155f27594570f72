"""The fleet layer of the PyTorch port (stoix_tpu_torch/resilience/fleet.py,
parallel/distributed.py::FleetStoreBackend) against the JAX package's
(stoix_tpu/resilience/fleet.py), on the same inputs: the decisions and flag
names, the decision from a gathered payload, the skew and its Prometheus
text, the store votes (a missing one included), the heartbeat monitor, the
guarded barrier, and the emergency store written by either package read by
the other with equal arrays, casts and digests. Then the live store under
concurrent threads, a one-process run with the fleet and HTTP on (the same
final state, bit for bit, as off), and the drills over two gloo ranks
(tests/torch_fleet_worker.py): SIGTERM to one rank stops both at the same
window on Anakin and on Sebulba, and `host_loss:2` on rank 1 has rank 0
exit 87 within its deadlines, naming process 1, with an emergency store a
relaunch at one process restores bit for bit.
"""

import datetime
import json
import os
import threading
import time
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from stoix_tpu.observability import exporters as jax_exporters
from stoix_tpu.observability import registry as jax_registry
from stoix_tpu.resilience import fleet as jax_fleet
from stoix_tpu.resilience.errors import FleetPartitionError as JaxFleetPartitionError
from stoix_tpu_torch import envs
from stoix_tpu_torch.observability import exporters, flightrec, registry
from stoix_tpu_torch.parallel.distributed import FleetStoreBackend
from stoix_tpu_torch.resilience import faultinject, fleet, integrity
from stoix_tpu_torch.resilience.errors import (
    FleetBarrierTimeout,
    FleetPartitionError,
)
from stoix_tpu_torch.resilience.exit_codes import EXIT_CODE_FLEET_PARTITION
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.anakin import make_seeds
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.checkpointing import flatten_state
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
import torch_fleet_worker as worker
import torch_parity  # noqa: F401  (one torch thread)

# The drills' deadlines (torch_fleet_worker.SHORT_DEADLINES): declared within
# heartbeat_timeout_s + one poll of the freeze, exit exit_grace_s after.
HEARTBEAT_TIMEOUT_S, MONITOR_POLL_S, EXIT_GRACE_S = 3.0, 0.5, 2.0
DRILL_MARGIN_S = 3.0  # thread start-up and a loaded host


@pytest.fixture(autouse=True)
def _no_fault_leakage():
    yield
    faultinject.reset()


def _settings(package, **overrides):
    base = dict(enabled=True, heartbeat_interval_s=0.05, heartbeat_timeout_s=0.5,
                monitor_poll_s=0.05, barrier_deadline_s=1.0, skew_warn_ratio=2.0,
                exit_grace_s=0.0, emergency_dir="checkpoints/fleet_emergency")
    base.update(overrides)
    return package.FleetSettings(**base)


def _coordinator(package, backend, **overrides):
    """A coordinator safe in-process: no interrupt, no hard exit."""
    return package.FleetCoordinator(_settings(package, **overrides), backend=backend,
                                    interrupt_on_partition=False)


def _mesh(processes):
    """A mesh as the JAX package's decoders read it: its devices' processes.
    The port's gathers put rank r's value in slot r, the JAX layout of one
    device a process in process order."""
    return types.SimpleNamespace(
        devices=np.array([types.SimpleNamespace(process_index=p) for p in processes]))


# ------------------------------------------------------------ settings and decisions


def test_settings_resolve_as_the_jax_package():
    for overrides in ([], ["arch.fleet.enabled=true", "arch.fleet.heartbeat_timeout_s=3",
                           "arch.fleet.emergency_dir=/x/y"]):
        cfg = config_lib.compose(config_lib.default_config_dir(),
                                 "default/anakin/default_ff_ppo.yaml", overrides)
        assert tuple(fleet.settings_from_config(cfg)) == tuple(jax_fleet.settings_from_config(cfg))
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             "default/anakin/default_ff_ppo.yaml", [])
    assert fleet.fleet_from_config(cfg) is None  # off by default
    on = config_lib.compose(config_lib.default_config_dir(),
                            "default/anakin/default_ff_ppo.yaml", ["arch.fleet.enabled=true"])
    coord = fleet.fleet_from_config(on)  # one process: no store
    assert coord.process_count == 1 and coord._backend is None


@pytest.mark.parametrize("bits", range(16))
def test_flags_and_decisions_describe_as_the_jax_package(bits):
    assert fleet.describe_flags(bits) == jax_fleet.describe_flags(bits)
    flags = {0: bits, 1: 0, 2: bits & 1}
    ours, theirs = fleet.FleetDecision(bits != 0, flags), jax_fleet.FleetDecision(bits != 0, flags)
    assert ours.describe() == theirs.describe()
    assert ours.stopping_processes == theirs.stopping_processes


@pytest.mark.parametrize("flags", [(0, 0, 1, 0), (0, 0), (2, 0, 9), (4, 1)])
def test_decide_from_fetch_and_per_process_equal_the_jax_package(flags):
    world = len(flags)
    ours = _coordinator(fleet, fleet.FakeFleetStore(world).view(0))
    theirs = _coordinator(jax_fleet, jax_fleet.FakeFleetStore(world).view(0))
    mesh = _mesh(range(world))
    values = np.asarray(flags, np.uint8)
    assert ours.decide_from_fetch(values, object()) == theirs.decide_from_fetch(values, mesh)
    walls = np.asarray([1.0 + p for p in flags], np.float32)
    assert ours._per_process(walls, object()) == theirs._per_process(walls, mesh)
    # One process: the bare payload, the port's as a tensor.
    solo, solo_jax = _coordinator(fleet, None), _coordinator(jax_fleet, None)
    solo.request_stop(fleet.FLAG_PREEMPT)
    solo_jax.request_stop(jax_fleet.FLAG_PREEMPT)
    assert solo.decide_from_fetch(solo.telemetry_for_fetch("cpu")) == \
        solo_jax.decide_from_fetch(solo_jax.telemetry_for_fetch(None))


def test_gathered_slots_are_ranks_on_the_ports_mesh():
    coord = _coordinator(fleet, fleet.FakeFleetStore(3).view(1))
    decision = coord.decide_from_fetch({"flags": np.asarray([0, 0, 8], np.uint8)}, mesh=object())
    assert decision.stop and decision.flags == {0: 0, 1: 0, 2: fleet.FLAG_CORRUPT}


@pytest.mark.parametrize("walls", [(1.0, 5.0), (2.0, 2.5), (np.nan, 1.0)])
def test_skew_and_its_prometheus_text_equal_the_jax_package(walls, monkeypatch):
    ours_reg, theirs_reg = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    monkeypatch.setattr(fleet, "get_registry", lambda: ours_reg)
    monkeypatch.setattr(jax_fleet, "get_registry", lambda: theirs_reg)
    mesh = _mesh((0, 1))
    ours = _coordinator(fleet, fleet.FakeFleetStore(2).view(0))
    theirs = _coordinator(jax_fleet, jax_fleet.FakeFleetStore(2).view(0))
    payload = {"wall": np.asarray(walls, np.float32)}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = ours.skew_from_fetch(payload, object(), 2)
        want = theirs.skew_from_fetch(payload, mesh, 2)
    assert got == want
    assert [str(w.message) for w in caught if w.category is fleet.FleetStragglerWarning] == [
        str(w.message) for w in caught if w.category is jax_fleet.FleetStragglerWarning]
    assert exporters.to_prometheus_text(ours_reg) == jax_exporters.to_prometheus_text(theirs_reg)
    # The host-side transport (Sebulba) exports the same gauges.
    from stoix_tpu_torch import parallel

    monkeypatch.setattr(parallel, "process_allgather",
                        lambda x: torch.tensor([[1.0], [3.0]], dtype=x.dtype))
    theirs._allgather_fn = lambda x: np.asarray([[1.0], [3.0]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert ours.observe_window_wall(3, 1.0) == theirs.observe_window_wall(3, 1.0) == 3.0
    assert exporters.to_prometheus_text(ours_reg) == jax_exporters.to_prometheus_text(theirs_reg)


# ------------------------------------------------------------ votes, heartbeats, barriers


def _vote_schedule(package, missing_at=None):
    """Two processes over `package`'s fake store voting windows 0..3; process
    0 requests a stop before window 2; process 1 never votes at `missing_at`.
    Returns each process's decisions (or the partition's missing list)."""
    store = package.FakeFleetStore(2)
    coords = [_coordinator(package, store.view(p)) for p in range(2)]
    results = {0: [], 1: []}

    def run(p):
        for window in range(4):
            if p == 0 and window == 2:
                coords[0].request_stop(package.FLAG_PREEMPT, note="SIGTERM")
            if p == 1 and window == missing_at:
                return
            try:
                decision = coords[p].agree_at_window(window, timeout_s=0.5)
                results[p].append((decision.stop, dict(decision.flags)))
            except (FleetPartitionError, JaxFleetPartitionError) as error:
                results[p].append(("partition", error.missing_processes))
                return

    threads = [threading.Thread(target=run, args=(p,)) for p in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20.0)
    return results


@pytest.mark.parametrize("missing_at", [None, 1])
def test_store_votes_decide_as_the_jax_package(missing_at):
    ours = _vote_schedule(fleet, missing_at)
    assert ours == _vote_schedule(jax_fleet, missing_at)
    if missing_at is None:
        assert ours[0] == ours[1] and ours[0][2] == (True, {0: fleet.FLAG_PREEMPT, 1: 0})
    else:
        assert ours[0][-1] == ("partition", [1])


def test_heartbeat_monitor_names_the_dead_peer():
    store = fleet.FakeFleetStore(2)
    a, b = _coordinator(fleet, store.view(0)), _coordinator(fleet, store.view(1))
    a.start()
    b.start()
    try:
        time.sleep(0.3)
        assert not a.partition_event.is_set() and not b.partition_event.is_set()
        a.stop()  # A's publisher stops: A "dies"
        deadline = time.monotonic() + 5.0
        while not b.partition_event.is_set() and time.monotonic() < deadline:
            time.sleep(0.02)
        with pytest.raises(FleetPartitionError) as excinfo:
            b.check_partition()
        assert excinfo.value.missing_processes == [0] and "process 0" in str(excinfo.value)
    finally:
        a.stop()
        b.stop()


def test_heartbeat_monitor_no_false_positive_while_beating():
    store = fleet.FakeFleetStore(2)
    a = _coordinator(fleet, store.view(0), heartbeat_timeout_s=0.4)
    b = _coordinator(fleet, store.view(1), heartbeat_timeout_s=0.4)
    a.start()
    b.start()
    try:
        time.sleep(1.0)
        assert not a.partition_event.is_set() and not b.partition_event.is_set()
    finally:
        a.stop()
        b.stop()


def test_guarded_barrier_passes_when_all_arrive_and_times_out_typed():
    store = fleet.FakeFleetStore(2)
    errors = []

    def arrive(pid):
        try:
            fleet.guarded_barrier("sync", store.view(pid), deadline_s=5.0)
        except Exception as exc:  # noqa: BLE001 -- the assert below reports it
            errors.append(exc)

    threads = [threading.Thread(target=arrive, args=(p,)) for p in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    assert not errors
    start = time.monotonic()
    with pytest.raises(FleetBarrierTimeout) as excinfo:
        fleet.guarded_barrier("lonely", fleet.FakeFleetStore(2).view(0), deadline_s=0.3)
    assert time.monotonic() - start < 0.3 + 1.0
    assert excinfo.value.barrier == "lonely"


def test_barrier_wedge_fault_trips_the_watchdog(monkeypatch):
    monkeypatch.setenv("STOIX_TPU_FAULT", "barrier_wedge")
    faultinject.configure()
    start = time.monotonic()
    with pytest.raises(FleetBarrierTimeout) as excinfo:
        fleet.guarded_barrier("wedged", fleet.FakeFleetStore(1).view(0), deadline_s=0.3)
    assert time.monotonic() - start < 5.0
    assert excinfo.value.dump is not None and "thread" in excinfo.value.dump


@pytest.mark.parametrize("scheme", ["tcp", "file"])
def test_live_store_concurrent_beats_and_votes_never_interleave_wrongly(scheme, tmp_path):
    """Two coordinators on one live store (a TCPStore or a FileStore): their
    heartbeat and monitor threads beat every 20 ms while the main threads
    vote 30 windows; every window's decision is the same on both, the stop
    lands at the window after it was requested, and no partition is seen."""
    if scheme == "tcp":
        server = dist.TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False,
                               timeout=datetime.timedelta(seconds=30))
        address = f"tcp://127.0.0.1:{server.port}"
    else:
        address = f"file://{tmp_path}/store"
    coords = [_coordinator(fleet, FleetStoreBackend(address, p, 2), heartbeat_interval_s=0.02,
                           monitor_poll_s=0.02, heartbeat_timeout_s=5.0) for p in range(2)]
    for coord in coords:
        coord.start()
    decisions = {0: [], 1: []}

    def vote(p):
        for window in range(30):
            if p == 1 and window == 20:
                coords[1].request_stop(fleet.FLAG_FAULT)
            decisions[p].append(coords[p].agree_at_window(window, timeout_s=10.0))

    try:
        threads = [threading.Thread(target=vote, args=(p,)) for p in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert decisions[0] == decisions[1] and len(decisions[0]) == 30
        assert [d.stop for d in decisions[0]] == [False] * 20 + [True] * 10
        assert all(d.flags == {0: 0, 1: fleet.FLAG_FAULT} for d in decisions[0][20:])
        assert not any(c.partition_event.is_set() for c in coords)
        assert coords[0]._backend.try_get("hb/1") not in (None, "0")
    finally:
        for coord in coords:
            coord.stop()


# ------------------------------------------------------------ emergency stores


def _jax_save(root, state, step=500):
    coord = jax_fleet.FleetCoordinator(_settings(jax_fleet, emergency_dir=str(root)),
                                       backend=None, process_index=0, process_count=1,
                                       interrupt_on_partition=False)
    coord.stage_candidate(step, state)
    coord.confirm_candidate(step)
    return coord.emergency_save()


def _port_save(root, state, step=500, process_count=1):
    coord = fleet.FleetCoordinator(_settings(fleet, emergency_dir=str(root)), backend=None,
                                   process_index=0, process_count=process_count,
                                   interrupt_on_partition=False)
    assert coord.emergency_save() is None  # nothing confirmed yet
    coord.stage_candidate(step, state)
    assert coord.emergency_save() is None  # staged, not confirmed
    coord.confirm_candidate(step)
    path = coord.emergency_save()
    assert coord.emergency_save() == path  # idempotent
    return path


def test_a_jax_emergency_store_reads_in_the_port(tmp_path):
    state = {"params": {"w": np.arange(12.0, dtype=np.float32).reshape(3, 4),
                        "b": np.ones(4, np.float32)},
             "count": np.asarray(7, np.int32),
             "bf": np.asarray(jnp.arange(6.0, dtype=jnp.bfloat16))}
    _jax_save(tmp_path / "jax", state)
    got = fleet.read_emergency_raw(str(tmp_path / "jax"))
    want = jax_fleet.read_emergency_raw(str(tmp_path / "jax"))
    assert got[1:] == want[1:] == ({"bf": "bfloat16"}, 500)
    assert got[0].keys() == want[0].keys()
    for key in want[0]:
        np.testing.assert_array_equal(got[0][key], want[0][key])
    assert integrity.digest_arrays(got[0]) == json.loads(
        (tmp_path / "jax" / "p0" / fleet.MANIFEST_NAME).read_text())["digests"]
    # And it restores into a port template of tensors, the bfloat16 leaf cast back.
    template = {"params": {"w": torch.zeros(3, 4), "b": torch.zeros(4)},
                "count": torch.zeros((), dtype=torch.int32),
                "bf": torch.zeros(6, dtype=torch.bfloat16)}
    restored, step = fleet.restore_emergency(template, str(tmp_path / "jax"))
    assert step == 500 and restored["bf"].dtype == torch.bfloat16
    assert torch.equal(restored["bf"].float(), torch.arange(6.0))
    assert torch.equal(restored["params"]["w"], torch.arange(12.0).reshape(3, 4))


def test_a_port_emergency_store_reads_in_the_jax_package(tmp_path):
    gen = torch.Generator().manual_seed(3)
    state = {"params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)},
             "count": 7, "bf": torch.arange(6.0, dtype=torch.bfloat16),
             "mask": torch.tensor([True, False]), "host": np.arange(3, dtype=np.int64),
             "generator": gen, "level": None, "beta": torch.tensor(0.5)}
    path = _port_save(tmp_path / "port", state)
    manifest = json.loads(open(os.path.join(path, fleet.MANIFEST_NAME)).read())
    assert manifest["process_count"] == 1 and manifest["partial"] == []
    assert manifest["casts"] == {"bf": "bfloat16"}
    want = jax_fleet.read_emergency_raw(str(tmp_path / "port"))
    got = fleet.read_emergency_raw(str(tmp_path / "port"))
    assert got[1:] == want[1:]
    for key in want[0]:
        np.testing.assert_array_equal(got[0][key], want[0][key])
    np.testing.assert_array_equal(want[0]["params/w"],
                                  np.arange(12.0, dtype=np.float32).reshape(3, 4))
    assert want[0]["count"] == 7 and want[0]["mask"].tolist() == [True, False]
    # Restored into a fresh template: every leaf, the generator's state included.
    fresh = torch.Generator().manual_seed(0)
    template = {"params": {"w": torch.zeros(3, 4), "b": torch.zeros(4)}, "count": 0,
                "bf": torch.zeros(6, dtype=torch.bfloat16),
                "mask": torch.zeros(2, dtype=torch.bool),
                "host": np.zeros(3, np.int64), "generator": fresh, "level": None,
                "beta": torch.tensor(0.0)}
    restored, step = fleet.restore_emergency(template, str(tmp_path / "port"))
    assert step == 500 and restored["count"] == 7 and restored["level"] is None
    assert restored["beta"].shape == () and float(restored["beta"]) == 0.5
    assert restored["generator"] is fresh and torch.equal(fresh.get_state(), gen.get_state())
    report = fleet.read_restore_report(str(tmp_path / "port"))
    assert report["digests"] == manifest["digests"] and report["reinitialized"] == []


def test_rank_bound_fields_are_partial_over_several_processes(tmp_path):
    state = {"params": {"w": torch.arange(4.0)}, "env_state": {"x": torch.ones(3)},
             "generator": torch.Generator().manual_seed(1), "timestep": torch.zeros(3)}
    path = _port_save(tmp_path / "two", state, process_count=2)
    manifest = json.loads(open(os.path.join(path, fleet.MANIFEST_NAME)).read())
    assert manifest["partial"] == ["env_state/x", "generator", "timestep"]
    assert set(manifest["digests"]) == {"params/w"}
    template = {"params": {"w": torch.zeros(4)}, "env_state": {"x": torch.zeros(5)},
                "generator": torch.Generator().manual_seed(9), "timestep": torch.zeros(5)}
    restored, _ = fleet.restore_emergency(template, str(tmp_path / "two"))
    assert torch.equal(restored["params"]["w"], torch.arange(4.0))
    assert torch.equal(restored["env_state"]["x"], torch.zeros(5))
    report = fleet.read_restore_report(str(tmp_path / "two"))
    assert report["matched"] == 1 and len(report["reinitialized"]) == 3


def test_a_rotted_store_is_rejected_by_both_packages(tmp_path):
    path = _port_save(tmp_path / "rot", {"w": torch.arange(8.0)})
    with np.load(os.path.join(path, "state.npz")) as data:
        arrays = {k: data[k].copy() for k in data.files}
    arrays["w"][3] = 99.0
    np.savez(os.path.join(path, "state.npz"), **arrays)
    from stoix_tpu.resilience.errors import CheckpointIntegrityError as JaxIntegrity
    from stoix_tpu_torch.resilience.errors import CheckpointIntegrityError

    with pytest.raises(CheckpointIntegrityError, match="sha256"):
        fleet.read_emergency_raw(str(tmp_path / "rot"))
    with pytest.raises(JaxIntegrity, match="sha256"):
        jax_fleet.read_emergency_raw(str(tmp_path / "rot"))


def test_find_manifests_orders_survivors_numerically(tmp_path):
    for pid in (10, 2):
        (tmp_path / f"p{pid}").mkdir()
        (tmp_path / f"p{pid}" / fleet.MANIFEST_NAME).write_text("{}")
    assert fleet._find_manifests(str(tmp_path)) == jax_fleet._find_manifests(str(tmp_path))
    assert fleet.is_emergency_store(str(tmp_path)) and not fleet.is_emergency_store(
        str(tmp_path / "nope"))


# ------------------------------------------------------------ runs


ROOT = "default/anakin/default_ff_ppo.yaml"


def _state_file(store, step):
    return torch.load(os.path.join(store, str(step), "state.pt"), weights_only=True)


def _same_payload(a, b):
    assert a.keys() == b.keys()
    for key, value in a.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, b[key]), key
        elif isinstance(value, dict):
            assert torch.equal(value["generator_state"], b[key]["generator_state"]), key
        else:
            assert value == b[key], key


def test_fleet_and_http_on_is_the_off_run_bit_for_bit(tmp_path, monkeypatch):
    from stoix_tpu_torch import observability

    monkeypatch.chdir(tmp_path)
    base = worker.SAVE + ["arch.num_evaluation=3", "arch.total_timesteps=192"]
    config = config_lib.compose(config_lib.default_config_dir(), ROOT, worker.TINY + base + [
        "logger.checkpointing.save_args.checkpoint_uid=u_off"])
    ff_ppo.run_experiment(config, device="cpu")
    config = config_lib.compose(config_lib.default_config_dir(), ROOT, worker.TINY + base + [
        "logger.checkpointing.save_args.checkpoint_uid=u_on", "arch.fleet.enabled=true",
        "logger.telemetry.http.enabled=true"])
    try:
        ff_ppo.run_experiment(config, device="cpu")
        assert observability.get_ops_server() is not None
    finally:
        observability.shutdown()
    stats = runner.LAST_RUN_STATS
    assert stats["resilience"]["fleet"] is True and stats["resilience"]["fleet_agreed_stop"] is None
    assert stats["fleet_rescue"]["staged"] == stats["fleet_rescue"]["confirmed"] == 3
    for step in (64, 128, 192):
        _same_payload(_state_file(tmp_path / "checkpoints" / "u_off" / "ff_ppo", step),
                      _state_file(tmp_path / "checkpoints" / "u_on" / "ff_ppo", step))


def test_sigterm_under_a_one_process_fleet_stops_through_the_agreement(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    config = config_lib.compose(config_lib.default_config_dir(), ROOT, worker.TINY + [
        "arch.num_evaluation=3", "arch.total_timesteps=192", "arch.fleet.enabled=true",
        "arch.fault_spec=sigterm:2", "logger.checkpointing.save_model=true",
        "logger.checkpointing.save_args.checkpoint_uid=final",
        "logger.checkpointing.save_args.save_interval_steps=1000000",
        "logger.checkpointing.save_args.max_to_keep=~"])
    ff_ppo.run_experiment(config, device="cpu")
    resilience = runner.LAST_RUN_STATS["resilience"]
    # sigterm:2 fires in the last window: the final-boundary vote catches it.
    assert resilience["preempted"] is True and "preempt" in resilience["fleet_agreed_stop"]
    saved = sorted(int(d) for d in os.listdir(tmp_path / "checkpoints" / "final" / "ff_ppo")
                   if d.isdigit())
    assert saved == [64, 192]  # the store's first save and the emergency one


# ------------------------------------------------------------ two ranks


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """Pair A runs the SIGTERM drills (Anakin, gossip groups, Sebulba); pair B the
    host_loss drill, timed from rank 1's freeze. Both pairs run at once."""
    root_a = tmp_path_factory.mktemp("fleet_a")
    root_b = tmp_path_factory.mktemp("fleet_b")
    pair_a = worker.spawn(str(root_a), "sigterm,gossip,sebulba")
    pair_b = worker.spawn(str(root_b), "host_loss")
    victim, survivor = pair_b[1][0], pair_b[0][0]
    frozen_at = exited_at = None
    deadline = time.monotonic() + 180.0
    while time.monotonic() < deadline and survivor.poll() is None:
        if frozen_at is None and worker.stopped(victim.pid):
            frozen_at = time.monotonic()
        time.sleep(0.02)
    exited_at = time.monotonic()
    codes_b, logs_b = worker.finish(pair_b, timeout=1.0)  # the frozen victim is killed here
    codes_a, logs_a = worker.finish(pair_a, timeout=180.0)
    assert codes_a == [0, 0], "\n".join(logs_a)
    outs = [json.loads((root_a / f"out{r}.json").read_text()) for r in range(2)]
    flight = json.loads((root_b / "emergency_loss" / "flight_record.json").read_text())
    return {"a": outs, "root_a": root_a, "root_b": root_b, "codes_b": codes_b, "logs_b": logs_b,
            "frozen_at": frozen_at, "exited_at": exited_at, "flight": flight}


def test_sigterm_to_one_of_two_ranks_stops_both_at_the_same_window(drills):
    for out in drills["a"]:
        record = out["sigterm"]
        assert record["windows"] == 2  # sigterm:0 on rank 1: the flag rides window 1's gather
        assert record["resilience"]["preempted"] is True
        assert record["resilience"]["fleet_agreed_stop"] == "fleet stop agreed (process 1: preempt)"
        assert record["rescue"]["staged"] == record["rescue"]["confirmed"] == 2
    store = drills["root_a"] / "checkpoints" / "fleet_sigterm" / "ff_ppo"
    assert sorted(os.listdir(store / "128")) == ["metrics.json", "state.0-of-2.pt",
                                                 "state.1-of-2.pt"]


def test_sigterm_stops_two_gossip_groups_at_the_same_window(drills):
    for out in drills["a"]:
        record = out["gossip"]
        assert record["windows"] == 2 and record["gossip_rounds"] >= 1
        assert record["resilience"]["fleet_agreed_stop"] == "fleet stop agreed (process 1: preempt)"


def test_sebulba_votes_agree_each_window_and_sigterm_stops_both(drills):
    ours, theirs = (out["sebulba"] for out in drills["a"])
    assert ours["decisions"] == theirs["decisions"] == [
        "fleet healthy", "fleet stop agreed (process 1: preempt)"]
    assert ours["learn_steps"] == theirs["learn_steps"] == 32  # two windows of 16 updates
    assert theirs["resilience"]["preempted"] and not ours["resilience"]["preempted"]
    assert ours["resilience"]["fleet"] and theirs["resilience"]["fleet"]


def test_host_loss_survivor_exits_87_within_its_deadlines_naming_process_1(drills):
    assert drills["codes_b"][0] == EXIT_CODE_FLEET_PARTITION, drills["logs_b"][0]
    assert drills["frozen_at"] is not None, "rank 1 never froze"
    took = drills["exited_at"] - drills["frozen_at"]
    assert took <= HEARTBEAT_TIMEOUT_S + MONITOR_POLL_S + EXIT_GRACE_S + DRILL_MARGIN_S, took
    assert took >= HEARTBEAT_TIMEOUT_S
    log = drills["logs_b"][0]
    assert "FleetPartitionError: fleet partition: process 1 silent past the 3s deadline" in log
    assert "hard exit 87" in log
    assert flightrec.validate_flight_record(drills["flight"]) == []
    assert drills["flight"]["exit_code"] == EXIT_CODE_FLEET_PARTITION
    assert any(e["kind"] == "fleet_partition" and e["missing"] == [1]
               for e in drills["flight"]["events"])
    assert (drills["root_b"] / "emergency_loss" / "p0" / fleet.MANIFEST_NAME).is_file()


def test_a_relaunch_at_one_process_restores_the_survivors_store(drills, tmp_path, monkeypatch):
    store = str(drills["root_b"] / "emergency_loss")
    manifest = json.loads(open(os.path.join(store, "p0", fleet.MANIFEST_NAME)).read())
    assert manifest["process_count"] == 2 and manifest["step"] == 128
    assert "generator" in manifest["partial"] and "env_state/generator" in manifest["partial"]
    monkeypatch.chdir(tmp_path)
    config = config_lib.compose(config_lib.default_config_dir(), ROOT, worker.TINY + [
        "arch.num_evaluation=2", "arch.total_timesteps=128",
        "logger.checkpointing.load_model=true",
        f"logger.checkpointing.load_args.load_path={store}"])
    # Every params/ leaf placed into a one-process template is the manifest's bytes.
    cfg = check_total_timesteps(config, 1)
    env, _ = envs.make(cfg)
    template = ff_ppo.learner_setup(env, cfg, torch.device("cpu"),
                                    make_seeds(int(cfg.arch.seed), 2)[0]).learner_state
    restored, step = fleet.restore_emergency(template, store)
    params = {"/".join(p): leaf for p, leaf in flatten_state(restored) if p[0] == "params"}
    assert step == 128 and params
    assert all(integrity.leaf_digest(leaf) == manifest["digests"][key]
               for key, leaf in params.items())
    # Only the rank-bound fields kept the template's values.
    report = fleet.read_restore_report(store)
    kept = {e.split(" ")[0].split("/")[0] for e in report["reinitialized"]}
    assert kept == {"generator", "env_state", "timestep"}
    # And the relaunch trains from it to its end.
    final = ff_ppo.run_experiment(config, device="cpu")
    stats = runner.LAST_RUN_STATS
    assert np.isfinite(final) and stats["resilience"]["restored_step"] == 128
    assert len(stats["window_seconds"]) == 2
