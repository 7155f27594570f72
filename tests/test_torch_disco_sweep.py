"""Anakin ff_disco103 of the PyTorch port on the CPU: the rollout fed the
JAX package's action draws (each step's Gumbel draws from the replica's key
chain), on CartPole from the JAX package's env states, against its own
`_env_step` scanned under vmap over "batch" at `update_batch_size` 1 and 2
(actions exact, observations and the five stored heads 1e-5 relative); each
rule mode at the JAX sweep's overrides (tests/test_systems_sweep.py:12-20,
77-78), finite with no B1 call; a resume bitwise the unbroken run (the
meta-state and every generator); C22's refusal and the minibatch
divisibility refusal. No download is ever tried (`urlretrieve` raises)."""

import inspect
import os

import jax
import numpy as np
import pytest
import torch

from stoix_tpu.systems.disco import ff_disco103 as jax_disco
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.networks.disco import DiscoAgentOutput
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.disco import ff_disco103
from stoix_tpu_torch.utils import config as config_lib
from test_torch_az import jax_core, jax_learner, replica
from test_torch_continuous import _count_b1_calls
from test_torch_disco_update import ROOT, SMALL, compose, no_download, port_learner  # noqa: F401
from torch_parity import n, t

# The JAX sweep's overrides (tests/test_systems_sweep.py:12-20, 77-78).
SWEEP = ["arch.total_num_envs=16", "arch.total_timesteps=2048", "arch.num_evaluation=1",
         "arch.num_eval_episodes=8", "arch.absolute_metric=False", "logger.use_console=False",
         "env=identity_game", "system.vmax=20.0", "system.num_minibatches=2"]


def jax_key_chain(key, steps):
    """The rollout's action draws' keys (`_env_step` splits (key, policy_key)
    each step)."""
    keys = []
    for _ in range(steps):
        key, policy_key = jax.random.split(key)
        keys.append(policy_key)
    return keys


@pytest.mark.parametrize("update_batch", [1, 2])
def test_rollout_fed_jax_draws_matches_the_jax_env_step(update_batch, monkeypatch, tmp_path):
    cfg, jcfg = compose(SMALL + [f"arch.update_batch_size={update_batch}",
                                 "arch.total_num_envs=8", "system.rollout_length=5"], tmp_path)
    jsetup, update_step = jax_learner(jax_disco, "get_learner_fn", None, jcfg, monkeypatch)
    env_step = inspect.getclosurevars(update_step).nonlocals["_env_step"]
    # Every leaf [U, ...] (the envs [U, E_u]): each replica's under vmap over "batch".
    jstate = jsetup.learner_state._replace(key=jsetup.learner_state.key[0])
    scan = jax.jit(jax.vmap(lambda s: jax.lax.scan(env_step, s, None, 5), axis_name="batch"))
    _, want = scan(jstate)

    setup, params = port_learner(cfg, replica(jstate.params))
    learner, state = setup.learn, setup.learner_state
    state = state._replace(params=ff_disco103.anakin.broadcast_to_update_batch(params,
                                                                               update_batch))
    # The JAX package's env states and observations in the port's wrappers.
    core = jax_core(jstate.env_state)
    flat = lambda x: t(np.asarray(x).reshape((-1,) + np.shape(x)[2:]))  # noqa: E731
    inner = state.env_state.inner
    state = state._replace(
        env_state=state.env_state._replace(inner=inner._replace(inner=inner.inner._replace(
            physics=flat(core.physics), step_count=flat(core.step_count)))),
        timestep=state.timestep._replace(observation=Observation(*(
            flat(getattr(jstate.timestep.observation, k)) for k in Observation._fields))))
    gumbels = []
    for u in range(update_batch):
        keys = jax_key_chain(jstate.key[u], 5)
        gumbels.append(np.stack([np.asarray(jax.random.gumbel(k, (8 // update_batch, 2)))
                                 for k in keys]))
    _, traj = learner.rollout(state, t(np.concatenate(gumbels, 1)))

    regroup = lambda x: np.swapaxes(np.asarray(x), 0, 1).reshape(  # noqa: E731
        (5, 8) + np.shape(x)[3:])
    assert not bool(traj.done.any())
    np.testing.assert_array_equal(n(traj.action), regroup(want.action))
    np.testing.assert_allclose(n(traj.obs.agent_view), regroup(want.obs.agent_view), rtol=1e-5,
                               atol=1e-6)
    for name in DiscoAgentOutput._fields:
        np.testing.assert_allclose(n(getattr(traj.agent_out, name)),
                                   regroup(getattr(want.agent_out, name)), rtol=1e-5, atol=1e-6,
                                   err_msg=name)




@pytest.mark.parametrize("mode", ["grounded", "meta"])
def test_each_rule_mode_runs_the_jax_sweep_without_a_b1_call(mode, monkeypatch, tmp_path):
    cfg, _ = compose(SWEEP + [f"system.rule_mode={mode}"], tmp_path)
    calls = _count_b1_calls(monkeypatch)
    assert np.isfinite(ff_disco103.run_experiment(cfg, device="cpu"))
    assert calls == {"gae": 0, "generic": 0}
    history = runner.LAST_RUN_STATS["history"]
    losses = [float(v) for row in history for k, v in row.items() if k.startswith("loss_")]
    assert losses and all(np.isfinite(losses))


def test_resume_after_window_one_is_bitwise_the_unbroken_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    window = 8 * 4

    def run(uid, windows, extra=()):
        config = config_lib.compose(config_lib.default_config_dir(), ROOT, SMALL + [
            "env=identity_game", "arch.total_num_envs=8", "system.rollout_length=4",
            "system.num_minibatches=2", "arch.num_eval_episodes=4", "logger.use_console=False",
            "logger.checkpointing.save_model=true",
            f"logger.checkpointing.save_args.checkpoint_uid={uid}",
            "logger.checkpointing.save_args.max_to_keep=~",
            f"arch.num_evaluation={windows}", f"arch.total_timesteps={windows * window}",
            *extra])
        ff_disco103.run_experiment(config, device="cpu")

    run("unbroken", 2)
    run("first", 1)
    run("resumed", 1, ["logger.checkpointing.load_model=true",
                       "logger.checkpointing.load_args.checkpoint_uid=first"])
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == window
    load = lambda uid: torch.load(  # noqa: E731
        os.path.join(tmp_path, "checkpoints", uid, "ff_disco103", str(2 * window), "state.pt"),
        weights_only=True)
    unbroken, resumed = load("unbroken"), load("resumed")
    assert unbroken.keys() == resumed.keys()
    assert any("generator" in key for key in unbroken)
    assert any(key.startswith("meta_state/target_params/") for key in unbroken)
    for key, value in unbroken.items():
        other = resumed[key]
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, other), key
        elif isinstance(value, dict):
            assert torch.equal(value["generator_state"], other["generator_state"]), key
        else:
            assert value == other, key
    assert int(unbroken["meta_state/num_updates"]) == 2 * 2 * 2
    assert unbroken["opt_states/count"] == 2 * 2 * 2


@pytest.mark.parametrize("extra,error,match", [
    (["system.update_guard=halt"], NotImplementedError, "system.update_guard"),
    (["system.num_minibatches=3"], ValueError, "divisible by system.num_minibatches"),
])
def test_the_reference_refusals(extra, error, match, tmp_path):
    cfg, _ = compose(SWEEP + extra, tmp_path)
    with pytest.raises(error, match=match):
        ff_disco103.run_experiment(cfg, device="cpu")
