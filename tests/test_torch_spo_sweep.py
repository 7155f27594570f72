"""Anakin SPO of the PyTorch port on the CPU: each system at the JAX sweep's
overrides (tests/test_systems_sweep.py:12-20, 69-76) at its default width,
finite, with one B1 GAE call an epoch under `multistep_impl=pallas`; the
rollout's stores; a resume bitwise the unbroken run; C22's refusal; the
IdentityGame oracle (chip_smoke.SPO_IDENTITY) above 8.0."""

import os

import numpy as np
import pytest
import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.spo import ff_spo, ff_spo_continuous
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from test_torch_continuous import _count_b1_calls
from torch_parity import n

ROOTS = {"ff_spo": "default/anakin/default_ff_spo.yaml",
         "ff_spo_continuous": "default/anakin/default_ff_spo_continuous.yaml"}
MODULES = {"ff_spo": ff_spo, "ff_spo_continuous": ff_spo_continuous}
# The JAX sweep's overrides (tests/test_systems_sweep.py:12-20, 69-76).
SWEEP = ["arch.total_num_envs=16", "arch.total_timesteps=2048", "arch.num_evaluation=1",
         "arch.num_eval_episodes=8", "arch.absolute_metric=False", "logger.use_console=False",
         "system.num_particles=8", "system.search_horizon=3", "system.rollout_length=8",
         "system.sample_sequence_length=8", "system.epochs=4"]
SWEEP_ENV = {"ff_spo": ["env=identity_game"], "ff_spo_continuous": []}
SMALL = ["network.actor_network.pre_torso.layer_sizes=[16,16]",
         "network.critic_network.pre_torso.layer_sizes=[16,16]"]


def compose(system, overrides):
    return config_lib.compose(config_lib.default_config_dir(), ROOTS[system], overrides)


@pytest.mark.parametrize("system", list(ROOTS))
def test_each_system_runs_the_jax_sweep_with_one_gae_call_an_epoch(system, monkeypatch):
    cfg = compose(system, SWEEP + SWEEP_ENV[system] + ["system.multistep_impl=pallas"])
    calls = _count_b1_calls(monkeypatch)
    final_return = MODULES[system].run_experiment(cfg, device="cpu")
    assert np.isfinite(final_return)
    updates = 2048 // (16 * 8)
    assert calls == {"gae": 4 * updates, "generic": 0}
    history = runner.LAST_RUN_STATS["history"]
    assert all(np.isfinite(float(v)) for row in history for k, v in row.items()
               if k.endswith("loss"))


def test_rollout_stores_sequences_of_the_search():
    cfg = check_total_timesteps(compose("ff_spo", SMALL + SWEEP + SWEEP_ENV["ff_spo"]), 1)
    setup = ff_spo.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 3)
    state, traj = setup.learn.rollout(setup.learner_state)
    buffer = state.buffer_state
    assert set(buffer.experience) == {"done", "truncated", "action", "particle_actions",
                                      "particle_weights", "particle_advs", "reward", "obs",
                                      "next_obs"}
    assert buffer.num_added == 8 and "info" in traj
    assert torch.equal(buffer.experience["particle_advs"][:, :8], traj["particle_advs"]
                       .transpose(0, 1))
    assert buffer.experience["particle_actions"].dtype == torch.int32
    # IdentityGame ends by termination only, at the 10th step.
    assert float(traj["truncated"].sum()) == 0.0
    np.testing.assert_allclose(n(traj["particle_weights"].sum(-1)), 1.0, rtol=1e-6)
    chosen = (traj["particle_actions"] == traj["action"][..., None]).any(-1)
    assert bool(chosen.all())


def test_resume_after_window_one_is_bitwise_the_unbroken_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    window = 8 * 8

    def run(uid, windows, extra=()):
        config = compose("ff_spo", SMALL + [
            "env=identity_game", "arch.total_num_envs=8", "system.rollout_length=8",
            "system.sample_sequence_length=4", "system.epochs=2", "system.num_particles=4",
            "system.search_horizon=2", "system.total_batch_size=4",
            "arch.num_eval_episodes=4", "logger.use_console=False",
            "logger.checkpointing.save_model=true",
            f"logger.checkpointing.save_args.checkpoint_uid={uid}",
            "logger.checkpointing.save_args.max_to_keep=~",
            f"arch.num_evaluation={windows}", f"arch.total_timesteps={windows * window}",
            *extra])
        ff_spo.run_experiment(config, device="cpu")

    run("unbroken", 2)
    run("first", 1)
    run("resumed", 1, ["logger.checkpointing.load_model=true",
                       "logger.checkpointing.load_args.checkpoint_uid=first"])
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == window
    load = lambda uid: torch.load(  # noqa: E731
        os.path.join(tmp_path, "checkpoints", uid, "ff_spo", str(2 * window), "state.pt"),
        weights_only=True)
    unbroken, resumed = load("unbroken"), load("resumed")
    assert unbroken.keys() == resumed.keys()
    assert any("generator" in key for key in unbroken)
    assert any(key.startswith("buffer_state/") for key in unbroken)
    assert any("log_temperature" in key for key in unbroken)
    for key, value in unbroken.items():
        other = resumed[key]
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, other), key
        elif isinstance(value, dict):
            assert torch.equal(value["generator_state"], other["generator_state"]), key
        else:
            assert value == other, key
    assert unbroken["opt_states/dual_opt_state/count"] == 2 * 2


@pytest.mark.parametrize("system", list(ROOTS))
def test_update_guard_which_the_reference_ignores_is_refused_naming_the_key(system):
    cfg = compose(system, SWEEP + SWEEP_ENV[system] + ["system.update_guard=skip"])
    with pytest.raises(NotImplementedError, match="system.update_guard"):
        MODULES[system].run_experiment(cfg, device="cpu")


def test_spo_learns_identity_game_above_the_oracle_threshold():
    """chip_smoke.py's spo_learn oracle on the CPU (64 envs, 16 384 steps, 16
    epochs; about 17 s on one thread): the JAX package returns 10.0 there
    for seeds 42 and 1 (scripts/jax_oracle_thresholds.py --oracles spo)."""
    import chip_smoke

    cfg = compose("ff_spo", chip_smoke.SPO_IDENTITY)
    assert ff_spo.run_experiment(cfg, device="cpu") > chip_smoke.A13_THRESHOLD
