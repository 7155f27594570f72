"""The rest of the port's classic.py and debug.py against the JAX
package's: Catch and SequenceGame step the same actions for 200 steps across
episode ends, each ended env reset on both sides from the draws JAX's reset
made (Catch's ball column, SequenceGame's cue, read from JAX's reset state),
everything exact. Acrobot and MountainCar: for 200 steps across episode
ends, each step from JAX's state of the step before (the port's physics set
to JAX's), physics, observations and rewards within 1e-5 relative (1e-6
absolute floor: sin and cos differ by an ulp between XLA and PyTorch, and
RK4 carries it), step types, discounts and truncations exact; and ten steps
run free from one start within 1e-4 relative. Then the registry: every
scenario of the slice under its JAX name, and an external suite's
`env.env_name` refused naming the key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.envs import classic as jclassic, debug as jdebug
from stoix_tpu_torch import envs
from stoix_tpu_torch.envs import classic, debug, registry
from stoix_tpu_torch.envs.types import tree_select
from stoix_tpu_torch.utils import config as config_lib
from torch_parity import env_lockstep, n, t


def test_catch_matches_jax_across_episode_ends():
    ends = env_lockstep(jclassic.Catch(), classic.Catch(), lambda s: np.asarray(s.ball_xy[:, 1]),
                        3, steps=200, num_envs=8, seed=2)
    assert ends >= 8 * 20  # every 9 steps each env ends


@pytest.mark.parametrize("delay", [3, 8])
def test_sequence_game_matches_jax_across_episode_ends(delay):
    ends = env_lockstep(jdebug.SequenceGame(delay=delay), debug.SequenceGame(delay=delay),
                        lambda s: np.asarray(s.cue), 4, steps=200, num_envs=8, seed=4)
    assert ends > 0


PHYSICS = {
    # name: (constructor kwargs; a short step limit puts truncations in 200 steps)
    "Acrobot": {"max_steps": 40},
    "MountainCar": {"max_steps": 50},
}


def _close(got, want, rtol):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("name", list(PHYSICS))
def test_physics_env_steps_like_jax_from_its_states(name):
    jenv, env = getattr(jclassic, name)(**PHYSICS[name]), getattr(classic, name)(**PHYSICS[name])
    reset, step = jax.jit(jax.vmap(jenv.reset)), jax.jit(jax.vmap(jenv.step))
    num_envs, generator = 8, torch.Generator().manual_seed(0)
    jstate, jts = reset(jax.random.split(jax.random.PRNGKey(0), num_envs))
    pstate, pts = env.reset_from_draws(t(jstate.physics), generator)
    _close(pts.observation.agent_view, jts.observation.agent_view, 1e-5)
    rng, ends = np.random.default_rng(0), 0
    for i in range(200):
        action = rng.integers(0, 3, size=num_envs)
        # One step from JAX's state.
        pstate = pstate._replace(physics=t(jstate.physics), step_count=t(jstate.step_count))
        jstate, jts = step(jstate, jnp.asarray(action, jnp.int32))
        pstate, pts = env.step(pstate, torch.from_numpy(action))
        _close(pstate.physics, jstate.physics, 1e-5)
        _close(pts.observation.agent_view, jts.observation.agent_view, 1e-5)
        np.testing.assert_array_equal(n(pts.reward), np.asarray(jts.reward))
        for key in ("step_type", "discount"):
            np.testing.assert_array_equal(n(getattr(pts, key)), np.asarray(getattr(jts, key)))
        np.testing.assert_array_equal(n(pts.extras["truncation"]),
                                      np.asarray(jts.extras["truncation"]))
        done = np.asarray(jts.step_type) == 2
        if done.any():
            ends += int(done.sum())
            rstate, _ = reset(jax.random.split(jax.random.PRNGKey(i + 1), num_envs))
            flag = jnp.asarray(done)
            jstate = jax.tree.map(
                lambda r, s: jnp.where(flag.reshape(flag.shape + (1,) * (s.ndim - 1)), r, s),
                rstate, jstate)
            pstate = tree_select(torch.from_numpy(done),
                                 env.reset_from_draws(t(rstate.physics), generator)[0], pstate)
    assert ends > 0


@pytest.mark.parametrize("name", list(PHYSICS))
def test_physics_env_ten_free_steps_stay_close_to_jax(name):
    jenv, env = getattr(jclassic, name)(), getattr(classic, name)()
    reset, step = jax.jit(jax.vmap(jenv.reset)), jax.jit(jax.vmap(jenv.step))
    jstate, _ = reset(jax.random.split(jax.random.PRNGKey(5), 8))
    pstate, _ = env.reset_from_draws(t(jstate.physics), torch.Generator())
    rng = np.random.default_rng(5)
    for _ in range(10):
        action = rng.integers(0, 3, size=8)
        jstate, jts = step(jstate, jnp.asarray(action, jnp.int32))
        pstate, pts = env.step(pstate, torch.from_numpy(action))
    np.testing.assert_allclose(n(pstate.physics), np.asarray(jstate.physics), rtol=1e-4,
                               atol=1e-6)


SLICE_SCENARIOS = ["Breakout-minatar", "Asterix-minatar", "Freeway-minatar",
                   "SpaceInvaders-minatar", "Breakout-atari", "Catch-bsuite", "Acrobot-v1",
                   "MountainCar-v0", "SequenceGame"]


@pytest.mark.parametrize("scenario", SLICE_SCENARIOS)
def test_scenario_is_registered_with_the_jax_spaces(scenario):
    from stoix_tpu.envs.registry import make_single as jax_make_single

    env, jenv = envs.make_single(scenario), jax_make_single(scenario)
    assert env.observation_space().agent_view.shape == jenv.observation_space().agent_view.shape
    assert env.num_actions == jenv.num_actions


def test_external_suite_env_name_is_refused_naming_the_key():
    cfg = config_lib.compose(config_lib.default_config_dir(), "default/anakin/default_ff_ppo.yaml",
                             ["env.env_name=gymnax"])
    assert cfg.env.scenario.name == "CartPole-v1"
    with pytest.raises(NotImplementedError, match="env.env_name='gymnax'"):
        envs.make(cfg)
    from stoix_tpu.envs.suites import SUITE_MAKERS

    assert set(registry.EXTERNAL_SUITES) == set(SUITE_MAKERS)
    # The first-party suite names build as before.
    envs.make(config_lib.compose(config_lib.default_config_dir(),
                                 "default/anakin/default_ff_ppo.yaml", ["env=breakout_jax"]))
