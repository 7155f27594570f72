"""The state-integrity sentinel of the PyTorch port
(stoix_tpu_torch/resilience/integrity.py) against the JAX package's
(stoix_tpu/resilience/integrity.py), on the same numpy inputs: the digests
and the fingerprint fold bitwise over mixed dtypes, the group names of the
ff_ppo learner state, the `bitflip` fault's one finite bit, the verdicts
and the quarantine record with its resume overrides; then the port's own
behaviour as the JAX tests pin it (tests/test_integrity.py): the
determinism probe clean on a healthy run and catching wrong math, and two
gloo ranks that agree when healthy and, under `bitflip:1`, exit 88 with
the quarantine file and flight record and no checkpoint of the flipped
window.
"""

import json
import os
import subprocess
import sys
import time
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from stoix_tpu.observability import flightrec as jax_flightrec
from stoix_tpu.resilience import integrity as jax_integrity
from stoix_tpu_torch.resilience import faultinject, integrity
from stoix_tpu_torch.resilience.errors import StateCorruptionError
from stoix_tpu_torch.resilience.exit_codes import EXIT_CODE_STATE_CORRUPTION
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
from torch_parity import n
from torch_ring_worker import REPO

GOLDEN = 0x9E3779B9
ROOT = "default/anakin/default_ff_ppo.yaml"
WINDOW = 2 * 4 * 8
TINY = ["env=identity_game", "arch.total_num_envs=8", "arch.num_updates_per_eval=2",
        "arch.num_eval_episodes=4", "arch.absolute_metric=False", "system.rollout_length=4",
        "system.epochs=1", "system.num_minibatches=2", "logger.use_console=False"]


@pytest.fixture(autouse=True)
def _no_fault_leakage():
    yield
    faultinject.reset()


def _leaves(seed):
    """Mixed-dtype numpy leaves: float32, bfloat16, int32, uint8, bool, an
    empty leaf and a scalar."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((7, 5)).astype(np.float32),
            rng.standard_normal((6,)).astype(ml_dtypes.bfloat16),
            rng.integers(-9, 9, (13,)).astype(np.int32),
            rng.integers(0, 256, (9,)).astype(np.uint8),
            rng.random((4,)) > 0.5,
            np.zeros((0, 3), np.float32),
            np.float32(3.5)]


def _as_torch(leaf):
    leaf = np.asarray(leaf)
    if leaf.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(leaf.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(leaf.copy())


def _settings(tmp_path, probe_interval=0):
    return integrity.IntegritySettings(True, probe_interval, str(tmp_path / "quarantine.json"))


# ------------------------------------------------------------ parity


def test_leaf_digest_and_records_equal_the_jax_package():
    leaves = _leaves(0)
    ours = integrity.digest_arrays({str(i): _as_torch(x) for i, x in enumerate(leaves)})
    theirs = jax_integrity.digest_arrays({str(i): np.asarray(x) for i, x in enumerate(leaves)})
    assert ours == theirs
    arrays = {"a": _as_torch(leaves[0]), "b": _as_torch(leaves[2])}
    record = integrity.digest_arrays(arrays)
    assert integrity.verify_digests(arrays, record) == []
    arrays["a"] = arrays["a"].clone()
    arrays["a"][0, 0] += 1.0
    assert integrity.verify_digests(arrays, record) == ["a"]


@pytest.mark.parametrize("seed,salt", [(0, 0), (1, 12345), (2, GOLDEN)])
def test_fingerprint_leaves_bitwise_the_jax_package(seed, salt):
    leaves = _leaves(seed)
    want = int(jax.jit(lambda *xs: jax_integrity.fingerprint_leaves(xs, salt))(
        *(jnp.asarray(x) for x in leaves)))
    assert integrity.fingerprint_leaves([_as_torch(x) for x in leaves], salt) == want
    # The leaf words: jax.lax.bitcast_convert_type's bytes, leaf by leaf.
    for leaf in leaves:
        np.testing.assert_array_equal(
            n(integrity._leaf_words(_as_torch(leaf))),
            np.asarray(jax_integrity._leaf_words(jnp.asarray(leaf))).astype(np.int64))


class _State(NamedTuple):
    params: Any
    opt_states: Any
    generator: Any
    env_state: Any
    obs_stats: Any


def test_fingerprinter_groups_equal_one_fold_a_group():
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    moments = (np.int32(5), rng.standard_normal((4, 3)).astype(np.float32))
    stats = rng.standard_normal(6).astype(np.float32)
    state = _State({k: _as_torch(v) for k, v in params.items()},
                   tuple(_as_torch(x) for x in moments), torch.Generator(),
                   torch.zeros(2), _as_torch(stats))
    assert integrity.replicated_group_specs(state) == [("params", 2), ("opt_states", 2),
                                                       ("obs_stats", 1)]
    got = integrity.Fingerprinter(state)(state)
    for g, (name, group) in enumerate((("params", list(params.values())),
                                       ("opt_states", list(moments)), ("obs_stats", [stats]))):
        salt = ((g + 1) * GOLDEN) & 0xFFFFFFFF
        want = int(jax_integrity.fingerprint_leaves([jnp.asarray(x) for x in group], salt))
        assert got[name] == want, name


def test_group_names_equal_the_jax_ff_ppo_state(devices):
    from stoix_tpu import envs as jax_envs
    from stoix_tpu.parallel.mesh import create_mesh
    from stoix_tpu.systems.ppo.anakin import ff_ppo as jax_ff_ppo
    from stoix_tpu.utils import config as jax_config_lib
    from stoix_tpu_torch import envs

    overrides = TINY + ["arch.num_updates=2"]
    jax_cfg = jax_config_lib.compose(jax_config_lib.default_config_dir(), ROOT, overrides)
    jax_env, _ = jax_envs.make(jax_cfg)
    jax_setup = jax_ff_ppo.learner_setup(jax_env, jax_cfg, create_mesh({"data": -1}),
                                         jax.random.PRNGKey(0))
    jax_groups = [name for name, _ in jax_integrity.replicated_group_specs(
        jax_setup.learner_state)]
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOT, overrides)
    env, _ = envs.make(cfg)
    setup = ff_ppo.learner_setup(env, cfg, torch.device("cpu"), 0)
    assert [name for name, _ in integrity.replicated_group_specs(setup.learner_state)] == (
        jax_groups)


def test_bitflip_changes_exactly_one_bit_and_stays_finite():
    state = _State({"w": torch.randn(8, 4, generator=torch.Generator().manual_seed(0)),
                    "b": torch.ones(4)}, (), torch.Generator(), torch.zeros(2), torch.zeros(1))
    assert faultinject.maybe_bitflip(state, 0) is state  # no plan: no-op
    faultinject.configure("bitflip:1")
    assert faultinject.maybe_bitflip(state, 0) is state  # not its window
    flipped = faultinject.maybe_bitflip(state, 1)
    before, after = state.params["w"], flipped.params["w"]
    assert torch.isfinite(after).all() and torch.equal(flipped.params["b"], state.params["b"])
    bits = (before.view(torch.int32) ^ after.view(torch.int32)).numpy().view(np.uint8)
    assert np.unpackbits(bits).sum() == 1  # one bit, of the largest leaf's largest element
    assert faultinject.maybe_bitflip(state, 1) is state  # one-shot


def _quarantine(module, sentinel, tmp_path, payload):
    sentinel.set_resume_info(str(tmp_path / "checkpoints" / "uid7" / "ff_ppo"))
    err = sentinel.verify(payload, window_idx=2, step=128)
    record = json.loads((tmp_path / "quarantine.json").read_text())
    for entry in record["quarantined"]:
        entry.pop("unix_time")
    return err, record, module.corruption_resume_overrides(str(tmp_path / "quarantine.json"))


def test_quarantine_record_and_resume_overrides_equal_the_jax_package(tmp_path):
    payload = {"params": np.asarray([5, 5, 9, 5], np.uint32),
               "opt_states": np.asarray([1, 1, 1, 1], np.uint32)}
    ours = integrity.StateIntegritySentinel(_settings(tmp_path / "port"))
    ours.group_names, ours._device_order = ["params", "opt_states"], [(r, r) for r in range(4)]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    theirs = jax_integrity.StateIntegritySentinel(jax_integrity.IntegritySettings(
        True, 0, str(tmp_path / "jax" / "quarantine.json")))
    # Devices 0..3 of one process each, as the port's ranks.
    theirs.group_names, theirs._device_order = ["params", "opt_states"], [(r, r) for r in range(4)]
    got = _quarantine(integrity, ours, tmp_path / "port", payload)
    want = _quarantine(jax_integrity, theirs, tmp_path / "jax", payload)
    assert got[0].devices == want[0].devices == [2] and got[0].groups == ["params"]
    assert str(got[0]) == str(want[0])
    for record in (got[1], want[1]):  # the absolute paths of two temporary directories
        record["resume_overrides"] = [o.replace(str(tmp_path / "port"), "T").replace(
            str(tmp_path / "jax"), "T") for o in record["resume_overrides"]]
    assert got[1] == want[1]
    assert [o.split("=")[0] for o in got[2]] == [o.split("=")[0] for o in want[2]]
    # The rc-88 flight record beside it is the JAX package's schema.
    flight = json.loads((tmp_path / "port" / "flight_record.json").read_text())
    assert jax_flightrec.validate_flight_record(flight) == []
    assert flight["exit_code"] == EXIT_CODE_STATE_CORRUPTION


def test_two_replica_tie_names_both_devices_not_a_guess(tmp_path):
    sentinel = integrity.StateIntegritySentinel(_settings(tmp_path)).bind(
        {"params": torch.ones(2), "opt_states": torch.ones(2)}, world=2)
    assert sentinel.verify({"params": np.asarray([7, 7], np.uint32),
                            "opt_states": np.asarray([3, 3], np.uint32)}, 0, 0) is None
    err = sentinel.verify({"params": np.asarray([1, 2], np.uint32),
                           "opt_states": np.asarray([7, 7], np.uint32)}, 0, 0)
    assert isinstance(err, StateCorruptionError)
    assert err.devices == [0, 1] and "undecidable" in err.detail
    assert sentinel.stats()["fingerprint_checks"] == 2


def test_tree_copy_keeps_one_generator_where_the_state_shares_one():
    shared = torch.Generator().manual_seed(3)
    state = {"a": shared, "b": (shared, torch.ones(2))}
    copy = integrity.tree_copy(state)
    assert copy["a"] is copy["b"][0] and copy["a"] is not shared
    assert torch.equal(torch.rand(3, generator=copy["a"]), torch.rand(3, generator=shared))


# ------------------------------------------------------------ determinism probe


def _run(extra, learn_wrapper=None, windows=3):
    def setup_fn(env, config, device, seed):
        setup = ff_ppo.learner_setup(env, config, device, seed)
        return setup if learn_wrapper is None else setup._replace(
            learn=learn_wrapper(setup.learn))

    cfg = config_lib.compose(config_lib.default_config_dir(), ROOT, TINY + list(extra) + [
        f"arch.num_evaluation={windows}", f"arch.total_timesteps={windows * WINDOW}"])
    return runner.run_anakin_experiment(cfg, setup_fn, "cpu", outer_axes=("group",))


def test_determinism_probe_passes_replay_and_catches_wrong_math(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # A verdict keeps the sentinel's excepthook installed (exit code 88);
    # the test process gets its own back.
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    probe = ["arch.integrity.enabled=true", "arch.integrity.determinism_probe_interval=2"]
    _run(probe)
    stats = runner.LAST_RUN_STATS["integrity"]
    assert stats["probe_runs"] == 1 and stats["fingerprint_checks"] == 3

    def wrong_math_on_replay(learn):
        calls = {"n": 0}

        def learn_fn(state):
            calls["n"] += 1
            out = learn(state)
            if calls["n"] == 3:  # the probe's replay, before window 2
                params = out.learner_state.params
                actor = dict(params.actor_params)
                key = next(iter(actor))
                actor[key] = actor[key] * (1.0 + 2 ** -20)
                out = out._replace(learner_state=out.learner_state._replace(
                    params=params._replace(actor_params=actor)))
            return out

        return learn_fn

    with pytest.raises(StateCorruptionError) as excinfo:
        _run(probe, wrong_math_on_replay)
    assert excinfo.value.kind == "determinism" and excinfo.value.groups == ["params"]
    record = json.loads((tmp_path / "checkpoints" / "quarantine.json").read_text())
    assert record["quarantined"][-1]["kind"] == "determinism"


# ------------------------------------------------------------ two gloo ranks


def test_two_ranks_agree_healthy_and_a_flip_exits_88_never_checkpointed(tmp_path):
    overrides = TINY + ["arch.num_evaluation=3", f"arch.total_timesteps={3 * WINDOW}",
                        "arch.integrity.enabled=true", "logger.checkpointing.save_model=true",
                        "logger.checkpointing.save_args.max_to_keep=~"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               STOIX_TPU_FAULT="")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    worker = os.path.join(REPO, "tests", "torch_ops_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(rank), "2", str(tmp_path), str(tmp_path / f"r{rank}.json"),
         *overrides], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO) for rank in range(2)]
    deadline = time.monotonic() + 240.0
    outputs = []
    for proc in procs:
        try:
            outputs.append(proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        finally:
            if proc.poll() is None:
                proc.kill()
    codes = [proc.returncode for proc in procs]
    assert codes == [EXIT_CODE_STATE_CORRUPTION] * 2, "\n".join(outputs)
    # Healthy: every window's fingerprints agreed on both ranks.
    for rank in range(2):
        healthy = json.loads((tmp_path / f"r{rank}.json").read_text())
        assert healthy["integrity"]["fingerprint_checks"] == 3
    # Flipped at window 1: the tie names both ranks, window 0 is saved and
    # the flipped window never is.
    record = json.loads((tmp_path / "checkpoints" / "quarantine.json").read_text())
    (entry,) = record["quarantined"]
    assert (entry["kind"], entry["window"], entry["devices"]) == ("replica_mismatch", 1, [0, 1])
    assert "logger.checkpointing.load_model=true" in record["resume_overrides"]
    store = tmp_path / "checkpoints" / "flipped" / "ff_ppo"
    assert sorted(int(d) for d in os.listdir(store) if d.isdigit()) == [WINDOW]
    flight = json.loads((tmp_path / "checkpoints" / "flight_record.json").read_text())
    assert jax_flightrec.validate_flight_record(flight) == []
    assert flight["exit_code"] == EXIT_CODE_STATE_CORRUPTION
    assert "silent state corruption" in outputs[0]
