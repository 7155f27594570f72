"""Checkpointing of the PyTorch port (stoix_tpu_torch/utils/checkpointing.py).

The JAX package's own restore tests are red in this container (orbax), so
the port is held by its own bar: a run saved after window 1, then loaded and
continued, ends bitwise equal to the unbroken run (params, optimizer states,
observation statistics, β, env state, timestep and every generator's
state). The store's layout and save policy follow the JAX Checkpointer's
keys (`checkpointer_from_config`): `checkpoints/<uid>/<system_name>/<step>/`,
`save_interval_steps`, `max_to_keep` (best by episode return) and
`keep_period`; a fleet store as `load_path` raises, naming `arch.fleet`.
"""

import json
import os

import numpy as np
import pytest
import torch

from stoix_tpu_torch.resilience.errors import CheckpointIntegrityError
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo, ff_trans_ppo
from stoix_tpu_torch.utils import checkpointing
from stoix_tpu_torch.utils import config as config_lib

WINDOW = 2 * 4 * 8  # steps a window: 2 updates of 4 steps x 8 envs
TINY = ["env=identity_game", "arch.total_num_envs=8", "arch.num_updates_per_eval=2",
        "arch.num_eval_episodes=4", "arch.absolute_metric=False", "system.rollout_length=4",
        "system.epochs=2", "system.num_minibatches=2", "logger.use_console=False"]
KNOBS = ["system.normalize_observations=true", "arch.update_batch_size=2",
         "system.update_guard=skip", "system.fused_update=true"]


def _config(overrides, root="default/anakin/default_ff_ppo.yaml"):
    return config_lib.compose(config_lib.default_config_dir(), root, overrides)


def _saved(store, step):
    return torch.load(os.path.join(store, str(step), checkpointing.STATE_FILE),
                      weights_only=True)


def _run(overrides, windows, uid, extra=()):
    save = ["logger.checkpointing.save_model=true",
            f"logger.checkpointing.save_args.checkpoint_uid={uid}",
            "logger.checkpointing.save_args.max_to_keep=~"]
    config = _config(TINY + KNOBS + save + list(extra) + [
        f"arch.num_evaluation={windows}", f"arch.total_timesteps={windows * WINDOW}"])
    return ff_ppo.run_experiment(config, device="cpu")


def test_resume_after_window_one_is_bitwise_the_unbroken_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _run([], 2, "unbroken")
    _run([], 1, "first")
    _run([], 1, "resumed", ["logger.checkpointing.load_model=true",
                            "logger.checkpointing.load_args.checkpoint_uid=first"])
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == WINDOW
    unbroken = _saved(tmp_path / "checkpoints" / "unbroken" / "ff_ppo", 2 * WINDOW)
    resumed = _saved(tmp_path / "checkpoints" / "resumed" / "ff_ppo", 2 * WINDOW)
    assert unbroken.keys() == resumed.keys()
    kinds = set()
    for key, value in unbroken.items():
        kinds.add(key.split("/")[0])
        other = resumed[key]
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, other), key
        elif isinstance(value, dict):  # a generator's state
            assert torch.equal(value["generator_state"], other["generator_state"]), key
        else:
            assert value == other, key
    assert kinds == {"params", "opt_states", "generator", "env_state", "timestep", "obs_stats",
                     "kl_beta"}
    assert any(k.startswith("params/actor_params") and v.shape[0] == 2
               for k, v in unbroken.items())  # the [U] replicas
    # And the run really trained: window 2's params differ from window 1's.
    first = _saved(tmp_path / "checkpoints" / "first" / "ff_ppo", WINDOW)
    assert not all(torch.equal(first[k], unbroken[k]) for k in first
                   if k.startswith("params/"))


def test_store_layout_and_metadata(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _run([], 2, "layout")
    store = tmp_path / "checkpoints" / "layout" / "ff_ppo"
    assert sorted(os.listdir(store)) == sorted([str(WINDOW), str(2 * WINDOW), "metadata.json",
                                                checkpointing.DIGEST_SIDECAR])
    meta = json.loads((store / "metadata.json").read_text())
    assert meta["checkpointer_version"] == checkpointing.CHECKPOINTER_VERSION
    assert meta["system"]["system_name"] == "ff_ppo"
    metrics = json.loads((store / str(WINDOW) / "metrics.json").read_text())
    assert metrics["step"] == WINDOW and np.isfinite(metrics["episode_return"])


def test_save_policy_interval_best_and_period(tmp_path):
    saver = checkpointing.Checkpointer("m", rel_dir=str(tmp_path), checkpoint_uid="u",
                                       save_interval_steps=2, max_to_keep=2, keep_period=6)
    state = {"w": torch.arange(3.0), "count": 1, "g": torch.Generator().manual_seed(1)}
    returns = {1: 5.0, 2: 1.0, 3: 9.0, 4: 3.0, 6: 0.0, 8: 7.0, 10: 2.0}
    taken = [step for step, ret in returns.items() if saver.save(step, state, ret)]
    # The first save is always taken (orbax's initial-save policy), then even steps.
    assert taken == [1, 2, 4, 6, 8, 10]
    # Kept: the 2 best returns (1 -> 5.0, 8 -> 7.0) and the multiples of 6.
    assert saver.all_steps() == [1, 6, 8]
    # `force` takes an odd step; the best two are then 8 -> 7.0 and 7 -> 8.0.
    assert saver.save(7, state, 8.0, force=True) and saver.all_steps() == [6, 7, 8]


def test_restore_refuses_a_mismatched_state_and_missing_steps(tmp_path):
    saver = checkpointing.Checkpointer("m", rel_dir=str(tmp_path), checkpoint_uid="u",
                                       max_to_keep=None)
    saver.save(3, {"w": torch.zeros(2)})
    with pytest.raises(FileNotFoundError, match="available steps: \\[3\\]"):
        saver.restore({"w": torch.zeros(2)}, 4)
    # A mismatch is a typed rejection of the step; with no other step the
    # fallback walk ends in CheckpointIntegrityError, naming it.
    with pytest.raises(CheckpointIntegrityError, match="shape"):
        saver.restore({"w": torch.zeros(3)})
    with pytest.raises(CheckpointIntegrityError, match="does not match"):
        saver.restore({"v": torch.zeros(2)})
    assert saver.last_restore_report[0]["reason"] == "structure"
    state, step = saver.restore({"w": torch.ones(2)})
    assert step == 3 and torch.equal(state["w"], torch.zeros(2))


def test_restore_sets_generator_states_in_place(tmp_path):
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    saver = checkpointing.Checkpointer("m", rel_dir=str(tmp_path), checkpoint_uid="u")
    saver.save(1, {"g": gen, "again": (gen,)})
    want = torch.rand(4, generator=gen)
    fresh = torch.Generator().manual_seed(0)
    state, _ = saver.restore({"g": fresh, "again": (fresh,)})
    assert state["g"] is fresh and state["again"][0] is fresh
    assert torch.equal(torch.rand(4, generator=fresh), want)


def test_a_fleet_store_as_load_path_raises_naming_arch_fleet(tmp_path, monkeypatch):
    """The refusal this test pinned is lifted: a fleet emergency store as
    `load_path` restores through fleet.restore_emergency. A one-process
    fleet run's rescue store resumes bit for bit; a manifest that is not one
    still fails, typed."""
    from stoix_tpu_torch.resilience import fleet

    (tmp_path / "bad" / "p0").mkdir(parents=True)
    (tmp_path / "bad" / "p0" / "fleet_manifest.json").write_text("{}")
    config = _config(TINY + ["logger.checkpointing.load_model=true",
                             f"logger.checkpointing.load_args.load_path={tmp_path / 'bad'}"])
    with pytest.raises(KeyError, match="step"):
        ff_ppo.run_experiment(config, device="cpu")
    monkeypatch.chdir(tmp_path)
    # A rescue store of window 0, then one window resumed from it: the resumed
    # run ends where an unbroken two-window run ends.
    coordinator = fleet.FleetCoordinator(
        fleet.settings_from_config(_config(TINY + [
            "arch.fleet.enabled=true", f"arch.fleet.emergency_dir={tmp_path / 'rescue'}"])))
    captured = []

    def capturing(env, cfg, device, seed):
        setup = ff_ppo.learner_setup(env, cfg, device, seed)
        learn = setup.learn

        def learn_and_stage(state):
            out = learn(state)
            if not captured:
                coordinator.stage_candidate(WINDOW, out.learner_state)
                coordinator.confirm_candidate(WINDOW)
                captured.append(coordinator.emergency_save())
            return out

        return setup._replace(learn=learn_and_stage)

    runner.run_anakin_experiment(_config(TINY + [
        "arch.num_evaluation=2", f"arch.total_timesteps={2 * WINDOW}",
        "logger.checkpointing.save_model=true", "logger.checkpointing.save_args.max_to_keep=~",
        "logger.checkpointing.save_args.checkpoint_uid=unbroken"]), capturing, "cpu",
        outer_axes=("group",))
    ff_ppo.run_experiment(_config(TINY + [
        "arch.num_evaluation=1", f"arch.total_timesteps={WINDOW}",
        "logger.checkpointing.load_model=true",
        f"logger.checkpointing.load_args.load_path={tmp_path / 'rescue'}",
        "logger.checkpointing.save_model=true",
        "logger.checkpointing.save_args.checkpoint_uid=resumed"]), device="cpu")
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == WINDOW
    unbroken = _saved(tmp_path / "checkpoints" / "unbroken" / "ff_ppo", 2 * WINDOW)
    resumed = _saved(tmp_path / "checkpoints" / "resumed" / "ff_ppo", 2 * WINDOW)
    assert unbroken.keys() == resumed.keys()
    for key, value in unbroken.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, resumed[key]), key
        elif isinstance(value, dict):  # a generator's state
            assert torch.equal(value["generator_state"], resumed[key]["generator_state"]), key
        else:
            assert value == resumed[key], key


def test_ff_trans_ppo_saves_and_resumes_with_update_batches(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    small = ["system.window_length=4", "system.num_layers=1", "system.num_heads=2",
             "system.head_dim=8", "system.ffn_dim=16", "arch.update_batch_size=2",
             "logger.checkpointing.save_model=true", "arch.num_evaluation=1",
             f"arch.total_timesteps={WINDOW}"]
    root = "default/anakin/default_ff_trans_ppo.yaml"
    first = ff_trans_ppo.run_experiment(_config(TINY + small + [
        "logger.checkpointing.save_args.checkpoint_uid=t1"], root), device="cpu")
    again = ff_trans_ppo.run_experiment(_config(TINY + small + [
        "logger.checkpointing.save_args.checkpoint_uid=t2", "logger.checkpointing.load_model=true",
        "logger.checkpointing.load_args.checkpoint_uid=t1"], root), device="cpu")
    assert np.isfinite(first) and np.isfinite(again)
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == WINDOW
    assert sorted(os.listdir(tmp_path / "checkpoints" / "t2" / "ff_trans_ppo")) == sorted(
        ["metadata.json", checkpointing.DIGEST_SIDECAR, str(2 * WINDOW)])
