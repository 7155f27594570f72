"""Anakin MuZero of the PyTorch port (stoix_tpu_torch/systems/search/
ff_mz.py) against the JAX package's, on the CPU, at a small width (a world
model of 16 with an LSTM, 601 atoms).

1. (One searched env step, fed the JAX package's draws, is in
   tests/test_torch_mz_env_step.py.)
2. Two epochs at `update_batch_size` 1 and 2 against the JAX package's own
   `_update_epoch` on the same sequences with terminations and truncations
   (the n-step targets, the unroll with `scale_gradient`, the two-hot
   cross-entropies): losses 1e-5 relative, params 1e-5 absolute; no B1
   call; with a GRU world model of two layers too.
3. The rollout stores what the JAX package stores; a resume bitwise the
   unbroken run; C20's refusals.
"""

import os

import jax
import numpy as np
import pytest
import torch

from stoix_tpu.systems.search import ff_mz as jax_mz
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch import envs
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.search import ff_mz
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from stoix_tpu_torch.utils.training import ClipAdam
from test_torch_az import jax_learner, replica
from test_torch_continuous import _count_b1_calls
from test_torch_sampled_search import jax_epochs_of, mz_networks
from torch_parity import n, t, to_flax_params

ROOT = "default/anakin/default_ff_mz.yaml"
SMALL = ["system.wm_hidden_size=16", "env=identity_game"]
SWEEP = ["arch.total_num_envs=16", "arch.total_timesteps=2048", "arch.num_evaluation=1",
         "arch.num_eval_episodes=8", "arch.absolute_metric=False", "system.rollout_length=8",
         "logger.use_console=False", "system.multistep_impl=pallas", "env=identity_game",
         "system.num_simulations=8"]
KEYS = ("policy_loss", "value_loss", "reward_loss", "entropy")


def compose(overrides):
    cfg = check_total_timesteps(config_lib.compose(config_lib.default_config_dir(), ROOT,
                                                   overrides), 1)
    return cfg, jax_config.compose(jax_config.default_config_dir(), ROOT, overrides)


def sequences(seed, batch, seq_len, obs_dim, num_actions):
    rng = np.random.default_rng(seed)
    lead = (batch, seq_len)
    weights = rng.random(lead + (num_actions,)).astype(np.float32)
    done = (rng.random(lead) < 0.1).astype(np.float32)
    return {
        "obs": rng.normal(size=lead + (obs_dim,)).astype(np.float32),
        "action": rng.integers(0, num_actions, lead).astype(np.int32),
        "reward": (rng.random(lead) < 0.4).astype(np.float32) * 1.5,
        "done": done,
        "truncated": ((rng.random(lead) < 0.15) & (done == 0)).astype(np.float32),
        "search_policy": weights / weights.sum(-1, keepdims=True),
        "search_value": rng.normal(2, 1, lead).astype(np.float32),
    }


@pytest.mark.parametrize("update_batch,cell", [(1, "lstm"), (2, "lstm"), (1, "gru")])
def test_epochs_match_jax_update_epoch(update_batch, cell, monkeypatch):
    overrides = SMALL + [f"arch.update_batch_size={update_batch}", "arch.total_num_envs=8",
                         "system.multistep_impl=pallas", "system.total_buffer_size=1024",
                         "system.total_batch_size=12", "system.lr=1e-3", "system.ent_coef=0.01",
                         f"system.wm_cell_type={cell}",
                         f"system.wm_rnn_layers={2 if cell == 'gru' else 1}"]
    cfg, jcfg = compose(overrides)
    jsetup, update_step = jax_learner(jax_mz, "get_learner_fn", 3, jcfg, monkeypatch)
    jparams, jopts = replica(jsetup.learner_state.params), replica(jsetup.learner_state.opt_states)
    seq_len = int(cfg.system.sample_sequence_length)
    seqs = [sequences(50 + u, 6, seq_len, 4, 4) for u in range(update_batch)]
    want = jax_epochs_of(update_step, jparams, jopts, seqs)
    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    nets, params = mz_networks(env, cfg, jparams, False)
    optim = ClipAdam(float(cfg.system.lr), float(cfg.system.max_grad_norm), eps=1e-5)
    update = ff_mz.MuZeroUpdate(nets, optim, cfg)
    params = [params] * update_batch
    opts = [ff_mz.MZOptStates(optim.init(ff_mz.flat_params(params[0])))] * update_batch
    batches = [{k: t(v) for k, v in s.items()} for s in seqs]
    calls = _count_b1_calls(monkeypatch)
    for wparams, wmetrics in want:
        params, opts, metrics = update(params, opts, batches)
        for key in KEYS:
            np.testing.assert_allclose(n(metrics[key]).reshape(update_batch), wmetrics[key][0],
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        for u in range(update_batch):
            for side in ff_mz.MZParams._fields:
                for g, w in zip(jax.tree.leaves(to_flax_params(getattr(params[u], side),
                                                               getattr(jparams, side))),
                                jax.tree.leaves(getattr(wparams, side))):
                    np.testing.assert_allclose(g, np.asarray(w)[0, u], rtol=0, atol=1e-5)
    assert calls == {"gae": 0, "generic": 0}
    assert opts[0].opt_state.count == 2


def test_rollout_stores_what_the_jax_package_stores():
    cfg, _ = compose(SMALL + SWEEP + ["system.total_buffer_size=4096",
                                      "system.total_batch_size=32"])
    setup = ff_mz.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 3)
    state, traj = setup.learn.rollout(setup.learner_state)
    buffer = state.buffer_state
    assert set(buffer.experience) == {"obs", "action", "reward", "done", "truncated",
                                      "search_policy", "search_value"}
    assert buffer.experience["action"].dtype == torch.int32 and buffer.num_added == 8
    assert buffer.experience["obs"].shape[-1] == 4 and "info" in traj
    assert torch.equal(buffer.experience["search_value"][:, :8], traj["search_value"].T)
    np.testing.assert_allclose(n(traj["search_policy"].sum(-1)), 1.0, rtol=1e-6)


def test_resume_after_window_one_is_bitwise_the_unbroken_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    window = 8 * 8

    def run(uid, windows, extra=()):
        config = config_lib.compose(
            config_lib.default_config_dir(), ROOT, SMALL + [
                "arch.total_num_envs=8", "system.rollout_length=8", "system.epochs=2",
                "system.num_simulations=4", "system.total_buffer_size=1024",
                "system.total_batch_size=8", "arch.num_eval_episodes=4",
                "logger.use_console=False", "logger.checkpointing.save_model=true",
                f"logger.checkpointing.save_args.checkpoint_uid={uid}",
                "logger.checkpointing.save_args.max_to_keep=~",
                f"arch.num_evaluation={windows}", f"arch.total_timesteps={windows * window}",
                *extra])
        ff_mz.run_experiment(config, device="cpu")

    run("unbroken", 2)
    run("first", 1)
    run("resumed", 1, ["logger.checkpointing.load_model=true",
                       "logger.checkpointing.load_args.checkpoint_uid=first"])
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == window
    load = lambda uid: torch.load(  # noqa: E731
        os.path.join(tmp_path, "checkpoints", uid, "ff_mz", str(2 * window), "state.pt"),
        weights_only=True)
    unbroken, resumed = load("unbroken"), load("resumed")
    assert unbroken.keys() == resumed.keys()
    assert any(key.startswith("buffer_state/") for key in unbroken)
    for key, value in unbroken.items():
        other = resumed[key]
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, other), key
        elif isinstance(value, dict):
            assert torch.equal(value["generator_state"], other["generator_state"]), key
        else:
            assert value == other, key
    assert unbroken["opt_states/opt_state/count"] == 2 * 2


@pytest.mark.parametrize("extra", ["system.update_guard=halt", "system.unroll_steps=2"])
def test_knobs_the_reference_ignores_are_refused_naming_the_key(extra):
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOT, SWEEP + [extra])
    with pytest.raises(NotImplementedError, match=extra.split("=")[0]):
        ff_mz.run_experiment(cfg, device="cpu")
