"""The operations layer of one process in the PyTorch port (stoix_tpu_torch/
resilience and the Anakin runner), held by the JAX package's own tests'
pins (tests/test_resilience.py): the update guard under an injected
`nan_loss`, SIGTERM to an emergency checkpoint and a resume bitwise the
unbroken run, the restore's fallback walk and its typed reasons, the
preflight probe (healthy, and wedged within its deadline), the config's
cross-checks (the JAX package's findings for the same configs), the
watchdogs, the memory gate, and a run with every switch on bitwise the run
with every switch off. Everything runs on the CPU at a tiny size.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from stoix_tpu.resilience import preflight as jax_preflight
from stoix_tpu.utils import config as jax_config_lib
from stoix_tpu_torch.observability import flightrec
from stoix_tpu_torch.ops import scan_kernels
from stoix_tpu_torch.resilience import (
    BackendUnavailableError,
    CheckpointIntegrityError,
    CompileStallError,
    ConfigValidationError,
    DivergenceError,
    PreemptionHandler,
    ResourcePreflightError,
    Watchdog,
    faultinject,
    preflight,
    watchdog,
)
from stoix_tpu_torch.resilience.exit_codes import EXIT_CODE_STALL
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import checkpointing
from stoix_tpu_torch.utils import config as config_lib
import torch_parity  # noqa: F401  (one torch thread)

ROOT = "default/anakin/default_ff_ppo.yaml"
WINDOW = 2 * 4 * 8  # env steps a window: 2 updates of 4 steps x 8 envs
TINY = ["env=identity_game", "arch.total_num_envs=8", "arch.num_updates_per_eval=2",
        "arch.num_eval_episodes=4", "arch.absolute_metric=False", "system.rollout_length=4",
        "system.epochs=1", "system.num_minibatches=2", "logger.use_console=False"]
# Every switch of the operations layer, with the CPU's cheap deadlines.
SWITCHES_ON = ["arch.preflight.enabled=true", "arch.integrity.enabled=true",
               "arch.integrity.determinism_probe_interval=1", "logger.telemetry.enabled=true",
               "logger.telemetry.device_poll_interval_s=0"]


@pytest.fixture(autouse=True)
def _no_fault_leakage():
    """One-shot fault state, and the multistep default a `pallas` run
    installs process-wide, never leak from one test into the next."""
    yield
    faultinject.reset()
    scan_kernels.set_default_impl("scan")


def _config(windows, extra=(), root=ROOT):
    return config_lib.compose(config_lib.default_config_dir(), root, TINY + list(extra) + [
        f"arch.num_evaluation={windows}", f"arch.total_timesteps={windows * WINDOW}"])


def _run_recorded(windows, extra=()):
    """ff_ppo through the runner on the CPU, recording the params after every
    learn step; returns (trajectory, final return)."""
    trajectory = []

    def recording_setup(env, config, device, seed):
        setup = ff_ppo.learner_setup(env, config, device, seed)
        learn = setup.learn

        def recording_learn(state):
            out = learn(state)
            trajectory.append({k: v.clone() for side in out.learner_state.params
                               for k, v in side.items()})
            return out

        return setup._replace(learn=recording_learn)

    final = runner.run_anakin_experiment(_config(windows, extra), recording_setup, "cpu",
                                         outer_axes=("group",))
    return trajectory, final


def _assert_identical(traj_a, traj_b):
    assert len(traj_a) == len(traj_b) and traj_a
    for window, (a, b) in enumerate(zip(traj_a, traj_b)):
        for key in a:
            assert torch.equal(a[key], b[key]), f"diverged at window {window}: {key}"


def _all_finite(params) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in params.values())


def _saved(store, step):
    return torch.load(os.path.join(store, str(step), checkpointing.STATE_FILE),
                      weights_only=True)


def _assert_same_payload(a, b):
    assert a.keys() == b.keys()
    for key, value in a.items():
        other = b[key]
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, other), key
        elif isinstance(value, dict):
            assert torch.equal(value["generator_state"], other["generator_state"]), key
        else:
            assert value == other, key


# ------------------------------------------------------------ divergence guard


@pytest.mark.parametrize("extra,skips", [([], 1.0), (["arch.update_batch_size=2"], 1.0)])
def test_nan_loss_skip_counter_exact_with_update_batch(monkeypatch, extra, skips):
    # One poisoned update is one skip, at U = 1 and at U = 2 (the replicas
    # decide together and flag once).
    monkeypatch.setenv("STOIX_TPU_FAULT", "nan_loss:2")
    traj, ret = _run_recorded(2, ["system.update_guard=skip", *extra])
    assert _all_finite(traj[-1]) and np.isfinite(ret)
    resilience = runner.LAST_RUN_STATS["resilience"]
    assert resilience["update_guard"] == "skip" and resilience["skipped_updates"] == skips


def test_nan_loss_halt_raises_divergence_error(monkeypatch):
    monkeypatch.setenv("STOIX_TPU_FAULT", "nan_loss:2")
    with pytest.raises(DivergenceError) as excinfo:
        _run_recorded(2, ["system.update_guard=halt"])
    err = excinfo.value
    assert err.metric in ("loss", "grad_norm") and not np.isfinite(err.loss) and err.step > 0


def test_nan_loss_with_guard_off_poisons_params(monkeypatch):
    # The failure the guard exists for: one non-finite update poisons the
    # params for good, and the run "completes".
    monkeypatch.setenv("STOIX_TPU_FAULT", "nan_loss:5")  # window 1's second update
    traj, _ = _run_recorded(2)
    assert _all_finite(traj[0]) and not _all_finite(traj[-1])


# ------------------------------------------------------------ preemption


def test_sigterm_emergency_checkpoint_and_bit_identical_resume(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # A cadence far beyond the run: the only state at the stop step is the
    # preemption path's forced emergency save.
    save = ["logger.checkpointing.save_model=true",
            "logger.checkpointing.save_args.checkpoint_uid=sigterm-test",
            "logger.checkpointing.save_args.save_interval_steps=1000000",
            "logger.checkpointing.save_args.max_to_keep=3"]
    monkeypatch.setenv("STOIX_TPU_FAULT", "sigterm:1")
    interrupted, _ = _run_recorded(4, save)  # returns: a clean exit
    monkeypatch.delenv("STOIX_TPU_FAULT")
    resilience = runner.LAST_RUN_STATS["resilience"]
    assert resilience["preempted"] is True and len(interrupted) == 2
    store = tmp_path / "checkpoints" / "sigterm-test" / "ff_ppo"
    assert checkpointing.Checkpointer("ff_ppo", checkpoint_uid="sigterm-test").all_steps() == [
        WINDOW, 2 * WINDOW]  # the store's first save and the emergency one

    uninterrupted, _ = _run_recorded(4, ["logger.checkpointing.save_model=true",
                                         "logger.checkpointing.save_args.checkpoint_uid=whole",
                                         "logger.checkpointing.save_args.max_to_keep=~"])
    _assert_identical(interrupted, uninterrupted[:2])
    resumed, _ = _run_recorded(2, [
        "logger.checkpointing.load_model=true",
        "logger.checkpointing.load_args.checkpoint_uid=sigterm-test",
        "logger.checkpointing.save_model=true",
        "logger.checkpointing.save_args.checkpoint_uid=resumed",
        "logger.checkpointing.save_args.max_to_keep=~"])
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == 2 * WINDOW
    _assert_identical(resumed, uninterrupted[2:])
    # The whole state, generators and env state included.
    _assert_same_payload(_saved(tmp_path / "checkpoints" / "resumed" / "ff_ppo", 4 * WINDOW),
                         _saved(tmp_path / "checkpoints" / "whole" / "ff_ppo", 4 * WINDOW))
    assert store.is_dir()


def test_preemption_handler_flags_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    handler = PreemptionHandler().install()
    try:
        assert not handler.stop_requested()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not handler.stop_requested() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert handler.stop_requested() and handler.signal_name == "SIGTERM"
        handler.acknowledge(7)
    finally:
        handler.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before
    # Off the main thread it installs nothing.
    box = {}
    thread = threading.Thread(target=lambda: box.update(h=PreemptionHandler().install()))
    thread.start()
    thread.join()
    assert not box["h"]._installed


# ------------------------------------------------------------ restore


def _store(tmp_path, steps, state_of=lambda step: {"w": torch.full((3,), float(step))}):
    saver = checkpointing.Checkpointer("m", rel_dir=str(tmp_path), checkpoint_uid="u",
                                       max_to_keep=None)
    for step in steps:
        saver.save(step, state_of(step), float(step))
    return saver


def _state_file(saver, step):
    return os.path.join(saver.directory, str(step), checkpointing.STATE_FILE)


def test_restore_falls_back_past_corrupt_and_truncated_checkpoints(tmp_path):
    saver = _store(tmp_path, [1, 2, 3])
    faultinject.corrupt_checkpoint_files(os.path.dirname(_state_file(saver, 3)))
    path = _state_file(saver, 2)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    state, step = saver.restore({"w": torch.zeros(3)})
    assert step == 1 and torch.equal(state["w"], torch.ones(3))
    report = saver.last_restore_report
    assert [r["step"] for r in report] == ["3", "2"]
    # A file torch.load cannot read rejects with the raising exception's type.
    assert all(r["reason"] not in ("structure", "non_finite", "digest") for r in report)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_restore_rejects_nonfinite(tmp_path, dtype):
    saver = _store(tmp_path, [1, 2], lambda step: {
        "w": torch.tensor([1.0, float("nan") if step == 2 else 2.0], dtype=dtype)})
    state, step = saver.restore({"w": torch.zeros(2, dtype=dtype)})
    assert step == 1 and state["w"].dtype == dtype
    assert saver.last_restore_report[0]["reason"] == "non_finite"
    # Every step unusable: the typed error, naming the steps tried.
    other = _store(tmp_path / "b", [5], lambda step: {"w": torch.full((2,), float("inf"),
                                                                      dtype=dtype)})
    with pytest.raises(CheckpointIntegrityError, match="no valid checkpoint"):
        other.restore({"w": torch.zeros(2, dtype=dtype)})


def test_digest_sidecar_rejects_bitrot_with_typed_fallback(tmp_path):
    saver = _store(tmp_path, [1, 2])
    record = checkpointing.saved_digest_record(saver.directory)
    assert sorted(record) == [1, 2] and "w" in record[2]
    # Bit-rot: a loadable file whose bytes are not the saved ones.
    payload = torch.load(_state_file(saver, 2), weights_only=True)
    payload["w"][0] = 99.0
    torch.save(payload, _state_file(saver, 2))
    state, step = saver.restore({"w": torch.zeros(3)})
    assert step == 1 and saver.last_restore_report[0]["reason"] == "digest"


def test_restore_missing_explicit_timestep_lists_available(tmp_path):
    saver = _store(tmp_path, [4, 8])
    faultinject.corrupt_checkpoint_files(os.path.dirname(_state_file(saver, 8)))
    with pytest.raises(FileNotFoundError, match=r"available steps: \[4, 8\]"):
        saver.restore({"w": torch.zeros(3)}, timestep=6)
    # An explicit step never falls back: its own error surfaces.
    with pytest.raises(Exception) as excinfo:
        saver.restore({"w": torch.zeros(3)}, timestep=8)
    assert not isinstance(excinfo.value, FileNotFoundError)
    assert saver.restore({"w": torch.zeros(3)}, timestep=4)[1] == 4


def test_env_driven_ckpt_corrupt_fires_once_on_save(tmp_path, monkeypatch):
    monkeypatch.setenv("STOIX_TPU_FAULT", "ckpt_corrupt")
    faultinject.configure()
    saver = _store(tmp_path, [1, 2])
    first = open(_state_file(saver, 1), "rb").read()
    assert first.startswith(b"\x00CORRUPTED")  # the first save took it, once
    assert not open(_state_file(saver, 2), "rb").read().startswith(b"\x00CORRUPTED")
    state, step = saver.restore({"w": torch.zeros(3)})
    assert step == 2 and torch.equal(state["w"], torch.full((3,), 2.0))


# ------------------------------------------------------------ preflight


def test_probe_backend_healthy_cpu_and_wedge_aborts_within_deadline(monkeypatch):
    probe = preflight.probe_backend(timeout_s=120.0, attempts=1)
    assert (probe.platform, probe.device_count, probe.attempts) == ("cpu", 1, 1)
    # A wedged backend (the child sleeps before touching CUDA) aborts with
    # the typed error within attempts x timeout + backoffs, never a hang.
    monkeypatch.setenv("STOIX_TPU_FAULT", "backend_wedge")
    start = time.monotonic()
    with pytest.raises(BackendUnavailableError) as excinfo:
        preflight.probe_backend(timeout_s=1.5, attempts=2, backoff_base_s=0.1,
                                backoff_max_s=0.2)
    assert time.monotonic() - start < 20.0
    assert excinfo.value.attempts == 2 and "timed out" in excinfo.value.last_error


BAD_CONFIGS = {
    "anakin_shapes": (ROOT, ["arch.total_num_envs=7", "arch.update_batch_size=3",
                             "system.update_guard=explode"], 1),
    "mesh_and_minibatches": (ROOT, ["arch.mesh.data=3", "system.num_minibatches=5",
                                    "arch.fault_spec=nan_loss:x"], 2),
    "bad_fault_arg_and_env": (ROOT, ["arch.fault_spec=sigterm:two", "env.scenario.name=nope"],
                              1),
    "network_sizes": (ROOT, ["network.actor_network.pre_torso.layer_sizes=[0,16]"], 1),
    "sebulba_split": ("default/sebulba/default_ff_ppo.yaml",
                      ["arch.learner.device_ids=[99]", "arch.total_num_envs=7"], 2),
}


@pytest.mark.parametrize("name", sorted(BAD_CONFIGS))
def test_validate_config_findings_equal_the_jax_package(name):
    root, overrides, devices = BAD_CONFIGS[name]
    port_cfg = config_lib.compose(config_lib.default_config_dir(), root, overrides)
    jax_cfg = jax_config_lib.compose(jax_config_lib.default_config_dir(), root, overrides)
    findings = []
    for module, cfg, error in ((preflight, port_cfg, ConfigValidationError),
                               (jax_preflight, jax_cfg, Exception)):
        try:
            module.validate_config(cfg, device_count=devices)
            findings.append([])
        except error as exc:
            findings.append(exc.findings)
    assert findings[0] and findings[0] == findings[1]
    preflight.validate_config(config_lib.compose(config_lib.default_config_dir(), ROOT, []),
                              device_count=1)


def test_validate_config_skips_device_checks_on_a_multi_process_launch(monkeypatch):
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOT, ["arch.mesh.data=4"])
    with pytest.raises(ConfigValidationError, match="covers 4 devices"):
        preflight.validate_config(cfg, device_count=1)
    monkeypatch.setenv("WORLD_SIZE", "4")
    preflight.validate_config(cfg, device_count=1)


def test_memory_gate_estimates_passes_and_rejects():
    cfg = _config(1)
    state = {"w": torch.zeros(1000)}
    estimate = preflight.predict_memory(state, cfg, {"obs": torch.zeros(4)})
    assert estimate["state_bytes"] == 4000
    assert estimate["rollout_bytes"] == 4 * 8 * (2 * 16 + 32)
    # The CPU exposes no limit: logged and passed.
    assert "limit_bytes" not in preflight.check_device_memory(estimate, "cpu")
    assert preflight.check_device_memory(estimate, "cpu", limit_bytes=10 ** 9)["limit_bytes"]
    with pytest.raises(ResourcePreflightError, match="predicted .* exceeds 90%"):
        preflight.check_device_memory(estimate, "cpu", headroom=0.9, limit_bytes=4000)
    # The measured half: window 0's peak against the limit found before it.
    gated = preflight.check_device_memory(estimate, "cpu", limit_bytes=10 ** 6)
    assert preflight.check_window_peak(gated, 900_000)["first_window_reserved_peak_bytes"] == (
        900_000)
    with pytest.raises(ResourcePreflightError, match="measured .* exceeds 90%.*window 0"):
        preflight.check_window_peak(gated, 900_001)
    assert preflight.check_window_peak(estimate, 10 ** 12)  # no limit on the CPU: passes


def test_run_preflight_report_renders_and_gates(monkeypatch):
    healthy = preflight.BackendProbe("cpu", "cpu", 1, 1, None, 1, 0.1)
    monkeypatch.setattr(preflight, "probe_backend", lambda **kwargs: healthy)
    good = config_lib.compose(config_lib.default_config_dir(), ROOT, [])
    bad = config_lib.compose(config_lib.default_config_dir(), ROOT, ["system.num_minibatches=5"])
    report = preflight.run_preflight([("good", good), ("bad", bad)])
    assert not report.ok and "overall: FAIL" in report.render()
    assert [status for _, status, _ in report.stages] == ["pass", "pass", "fail"]
    assert preflight.run_preflight(good).ok


# ------------------------------------------------------------ watchdogs


def test_watchdog_stall_dumps_and_raises():
    with pytest.raises(CompileStallError) as excinfo:
        with Watchdog("unit_stage", deadline_s=0.2):
            # The interrupt lands between bytecodes: a sliced sleep takes it
            # at once, a monolithic one only when it returns.
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                time.sleep(0.05)
    err = excinfo.value
    assert err.stage == "unit_stage" and "thread" in err.dump and "registry snapshot" in err.dump


def test_watchdog_clean_section_is_transparent():
    with Watchdog("unit_ok", deadline_s=30.0) as dog:
        value = 1 + 1
    assert value == 2 and not dog.stalled


def test_slow_compile_trips_first_compile_watchdog(monkeypatch):
    healthy = preflight.BackendProbe("cpu", "cpu", 1, 1, None, 1, 0.1)
    monkeypatch.setattr(preflight, "probe_backend", lambda **kwargs: healthy)
    monkeypatch.setenv("STOIX_TPU_FAULT", "slow_compile:10")
    start = time.monotonic()
    with pytest.raises(CompileStallError, match="first_compile"):
        _run_recorded(1, ["arch.preflight.enabled=true",
                          "arch.preflight.compile_deadline_s=0.5"])
    assert time.monotonic() - start < 8.0


def test_rc86_watchdog_hard_exit_leaves_flight_record(tmp_path, monkeypatch):
    exits = []
    monkeypatch.setattr(os, "_exit", lambda code: exits.append(code))
    monkeypatch.chdir(tmp_path)  # the rc-86 dump lands under ./checkpoints
    flightrec.get_flight_recorder().record("window", window=0)
    dog = watchdog.Watchdog("first_window", deadline_s=600.0, hard_exit_grace_s=0.01)
    dog._hard_exit()
    assert exits == [EXIT_CODE_STALL]
    record = json.load(open(tmp_path / "checkpoints" / "flight_record.json"))
    assert flightrec.validate_flight_record(record) == []
    assert record["exit_code"] == EXIT_CODE_STALL and "first_window" in record["reason"]


# ------------------------------------------------------------ on == off


def test_every_switch_on_is_the_switches_off_run_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    save = ["logger.checkpointing.save_model=true", "system.update_guard=skip",
            "system.multistep_impl=pallas", "logger.checkpointing.save_args.max_to_keep=~"]
    off, _ = _run_recorded(3, save + ["logger.checkpointing.save_args.checkpoint_uid=u_off"])
    off_stats = dict(runner.LAST_RUN_STATS)
    on, _ = _run_recorded(3, save + SWITCHES_ON + [
        "logger.checkpointing.save_args.checkpoint_uid=u_on", f"logger.base_exp_path={tmp_path}"])
    stats = runner.LAST_RUN_STATS
    _assert_identical(off, on[::2])  # before windows 1 and 2 the probe replays window 0
    _assert_same_payload(_saved(tmp_path / "checkpoints" / "u_off" / "ff_ppo", 3 * WINDOW),
                         _saved(tmp_path / "checkpoints" / "u_on" / "ff_ppo", 3 * WINDOW))
    assert stats["integrity"]["probe_runs"] == 2 and stats["integrity"]["fingerprint_checks"] == 3
    assert stats["resilience"]["preflight"] and stats["preflight"]["probe"]["platform"] == "cpu"
    assert stats["preflight"]["memory"]["predicted_bytes"] > 0
    assert off_stats["integrity"] == {"enabled": False, "fingerprint_checks": 0,
                                      "overhead_s": 0.0, "probe_runs": 0}
    goodput = stats["goodput"]
    assert abs(sum(goodput["fractions"].values()) - 1.0) < 1e-9
    assert (tmp_path / "checkpoints" / "u_on" / "ff_ppo" / checkpointing.DIGEST_SIDECAR).is_file()
