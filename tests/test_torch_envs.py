"""Batched envs of the PyTorch port against the JAX package's envs: a JAX
env state is converted to the port's, both are stepped with the same
actions, and every output is compared until the first auto-reset. Resets
draw different random numbers in the two frameworks, so after an auto-reset
only its semantics are checked: `extras["next_obs"]` is the true terminal
observation, the observation restarts, and step limits keep discount 1.

Tolerance: CartPole physics 1e-5 absolute (sin/cos differ by an ulp between
XLA and PyTorch); everything else exact. The continuous envs (Pendulum,
MountainCarContinuous) are held on explicit states and actions, one step and
a short horizon from each: Pendulum's physics, observation and reward 1e-5
relative (1e-5 absolute near zero), MountainCarContinuous's 1e-6 absolute,
step types, discounts and terminations exact.
"""

import jax
import numpy as np
import pytest
import torch

from stoix_tpu.envs import classic as jclassic, debug as jdebug, wrappers as jwrappers
from stoix_tpu_torch.envs import classic, debug, wrappers
from stoix_tpu_torch.envs.types import StepType, get_final_step_metrics
from torch_parity import n, t

N = 16


def _jax_env(raw, **kwargs):
    env = jwrappers.apply_core_wrappers(raw, num_envs=N, **kwargs)
    return env, env.reset(jax.random.split(jax.random.PRNGKey(0), N))


def _cartpole_state_to_port(jstate, generator):
    metrics, physics = jstate.inner, jstate.inner.inner
    return wrappers.AutoResetState(
        wrappers.EpisodeMetricsState(
            classic.PhysicsState(generator, t(physics.physics), t(physics.step_count)),
            t(metrics.episode_return), t(metrics.episode_length),
        ),
        generator,
    )


def _compare(jts, tts, not_done, physics_atol):
    np.testing.assert_array_equal(n(tts.step_type), np.asarray(jts.step_type))
    np.testing.assert_array_equal(n(tts.reward), np.asarray(jts.reward))
    np.testing.assert_array_equal(n(tts.discount), np.asarray(jts.discount))
    np.testing.assert_array_equal(n(tts.extras["truncation"]), np.asarray(jts.extras["truncation"]))
    np.testing.assert_allclose(n(tts.extras["next_obs"].agent_view),
                               np.asarray(jts.extras["next_obs"].agent_view), atol=physics_atol)
    np.testing.assert_allclose(n(tts.observation.agent_view)[not_done],
                               np.asarray(jts.observation.agent_view)[not_done], atol=physics_atol)
    for key in ("episode_return", "episode_length", "is_terminal_step"):
        np.testing.assert_array_equal(n(tts.extras["episode_metrics"][key]),
                                      np.asarray(jts.extras["episode_metrics"][key]))


def test_cartpole_matches_jax_until_first_autoreset_then_resets_correctly():
    jenv, (jstate, jts) = _jax_env(jclassic.CartPole())
    tenv = wrappers.apply_core_wrappers(classic.CartPole())
    gen = torch.Generator().manual_seed(0)
    tstate = _cartpole_state_to_port(jstate, gen)
    rng = np.random.default_rng(0)
    for step in range(200):
        actions = rng.integers(0, 2, size=N)
        jstate, jts = jenv.step(jstate, jax.numpy.asarray(actions, jax.numpy.int32))
        tstate, tts = tenv.step(tstate, t(actions))
        done = np.asarray(jts.last())
        _compare(jts, tts, ~done, physics_atol=1e-5)
        if done.any():
            break
    assert done.any(), "no CartPole episode ended within 200 random steps"
    # Auto-reset: the done envs restart (step 0, near-zero physics) while
    # next_obs keeps the true terminal observation checked above.
    obs = tts.observation
    assert np.all(n(obs.step_count)[done] == 0)
    assert np.all(np.abs(n(obs.agent_view)[done]) <= 0.05)
    assert np.all(n(tts.discount)[done] == 0.0)  # a termination, not a truncation
    finals = get_final_step_metrics(tts.extras["episode_metrics"])
    np.testing.assert_array_equal(finals["episode_length"], np.full(done.sum(), step + 1))
    # The next step starts counting a new episode for the reset envs.
    tstate, tts = tenv.step(tstate, t(np.zeros(N, np.int64)))
    assert np.all(n(tts.extras["episode_metrics"]["episode_length"])[done] == 1)


def test_step_limit_truncates_with_discount_one():
    # CartPole's own step limit and the EpisodeStepLimit wrapper both truncate.
    jenv, (jstate, _) = _jax_env(jclassic.CartPole(max_steps=5))
    tenv = wrappers.apply_core_wrappers(classic.CartPole(max_steps=5))
    tstate = _cartpole_state_to_port(jstate, torch.Generator().manual_seed(1))
    for step in range(5):
        actions = np.array([0, 1] * (N // 2))
        jstate, jts = jenv.step(jstate, jax.numpy.asarray(actions, jax.numpy.int32))
        tstate, tts = tenv.step(tstate, t(actions))
        _compare(jts, tts, ~np.asarray(jts.last()), physics_atol=1e-5)
    assert np.all(n(tts.step_type) == StepType.LAST)
    assert np.all(n(tts.discount) == 1.0)
    assert np.all(n(tts.extras["truncation"]))

    tenv = wrappers.apply_core_wrappers(debug.IdentityGame(4, 10), max_episode_steps=3)
    tstate, _ = tenv.reset(torch.Generator().manual_seed(2), N)
    for _ in range(3):
        tstate, tts = tenv.step(tstate, torch.zeros(N, dtype=torch.int64))
    assert np.all(n(tts.step_type) == StepType.LAST)
    assert np.all(n(tts.discount) == 1.0)
    assert np.all(n(tts.extras["truncation"]))
    assert np.all(n(tts.extras["next_obs"].step_count) == 3)
    assert np.all(n(tts.observation.step_count) == 0)


def test_identity_game_matches_jax_rewards_and_episode_ends():
    jenv, (jstate, jts) = _jax_env(jdebug.IdentityGame(4, 10))
    tenv = wrappers.apply_core_wrappers(debug.IdentityGame(4, 10))
    gen = torch.Generator().manual_seed(3)
    identity = jstate.inner.inner
    tstate = wrappers.AutoResetState(
        wrappers.EpisodeMetricsState(
            debug.IdentityState(gen, t(identity.target, torch.int64), t(identity.step_count)),
            t(jstate.inner.episode_return), t(jstate.inner.episode_length),
        ),
        gen,
    )
    np.testing.assert_array_equal(n(tenv.reset(gen, N)[1].observation.agent_view).sum(-1), 1.0)
    # The port's targets differ from JAX's after the first step (another RNG),
    # so act with each side's own target on even envs and off-target on odd.
    for _ in range(10):
        j_target = np.asarray(jstate.inner.inner.target)
        t_target = n(tstate.inner.inner.target)
        offset = np.arange(N) % 2
        jstate, jts = jenv.step(jstate, jax.numpy.asarray((j_target + offset) % 4))
        tstate, tts = tenv.step(tstate, t((t_target + offset) % 4))
        for name in ("step_type", "reward", "discount"):
            np.testing.assert_array_equal(n(getattr(tts, name)), np.asarray(getattr(jts, name)))
        for key in ("episode_return", "episode_length", "is_terminal_step"):
            np.testing.assert_array_equal(n(tts.extras["episode_metrics"][key]),
                                          np.asarray(jts.extras["episode_metrics"][key]))
        np.testing.assert_array_equal(n(tts.observation.agent_view).sum(-1), 1.0)
    # Episode 10 ends by termination: returns 10 on even envs, 0 on odd.
    assert np.all(n(tts.discount) == 0.0)
    np.testing.assert_array_equal(n(tts.extras["episode_metrics"]["episode_return"]),
                                  np.where(np.arange(N) % 2 == 0, 10.0, 0.0))


def _continuous_states(name, count, seed):
    rng = np.random.default_rng(seed)
    if name == "Pendulum-v1":
        # Angles past +-pi on both sides, where the floor-mod matters.
        theta = rng.uniform(-3 * np.pi, 3 * np.pi, size=count)
        thdot = rng.uniform(-8.0, 8.0, size=count)
        return np.stack([theta, thdot], -1).astype(np.float32), 2.0
    pos = rng.uniform(-1.2, 0.6, size=count)
    vel = rng.uniform(-0.07, 0.07, size=count)
    return np.stack([pos, vel], -1).astype(np.float32), 1.0


@pytest.mark.parametrize("name", ["Pendulum-v1", "MountainCarContinuous-v0"])
def test_continuous_env_steps_match_jax_on_explicit_states(name):
    from stoix_tpu.envs.registry import make_single as jax_make_single
    from stoix_tpu_torch.envs.registry import make_single

    jenv, tenv = jax_make_single(name, max_steps=8), make_single(name, max_steps=8)
    physics, bound = _continuous_states(name, 64, seed=0)
    actions = np.random.default_rng(1).uniform(-1.5 * bound, 1.5 * bound,
                                               size=(8, 64, 1)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5) if name == "Pendulum-v1" else dict(rtol=0, atol=1e-6)
    jstate = jclassic.PhysicsState(jax.random.split(jax.random.PRNGKey(0), 64),
                                   jax.numpy.asarray(physics), jax.numpy.zeros(64, jax.numpy.int32))
    tstate = classic.PhysicsState(torch.Generator().manual_seed(0), t(physics),
                                  torch.zeros(64, dtype=torch.int32))
    jstep = jax.jit(jax.vmap(jenv.step))
    for step in range(8):
        # Both from the same state each step, so an ulp never compounds.
        jstate, jts = jstep(jstate, jax.numpy.asarray(actions[step]))
        tstate, tts = tenv.step(tstate, t(actions[step]))
        np.testing.assert_allclose(n(tstate.physics), np.asarray(jstate.physics), **tol)
        np.testing.assert_allclose(n(tts.observation.agent_view),
                                   np.asarray(jts.observation.agent_view), **tol)
        np.testing.assert_allclose(n(tts.reward), np.asarray(jts.reward), **tol)
        for field in ("step_type", "discount"):
            np.testing.assert_array_equal(n(getattr(tts, field)), np.asarray(getattr(jts, field)))
        np.testing.assert_array_equal(n(tts.extras["truncation"]),
                                      np.asarray(jts.extras["truncation"]))
        tstate = tstate._replace(physics=t(np.asarray(jstate.physics)))
    # The 8th step is the step limit: a truncation that keeps discount 1
    # (tests/test_envs.py::test_pendulum_truncates_with_discount_one), unless
    # the car reached the flag.
    truncated = n(tts.extras["truncation"])
    assert np.all(n(tts.step_type) == StepType.LAST)
    assert np.all(n(tts.discount)[truncated] == 1.0)
    assert np.all(n(tts.discount)[~truncated] == 0.0)
    if name == "Pendulum-v1":
        assert truncated.all()


@pytest.mark.parametrize("name", ["Pendulum-v1", "MountainCarContinuous-v0"])
def test_continuous_env_short_horizon_matches_jax(name):
    """Ten steps from the same states under the same actions, each side on
    its own state: the errors compound no further than the tolerance."""
    from stoix_tpu.envs.registry import make_single as jax_make_single
    from stoix_tpu_torch.envs.registry import make_single

    jenv, tenv = jax_make_single(name), make_single(name)
    physics, bound = _continuous_states(name, 32, seed=2)
    actions = np.random.default_rng(3).uniform(-bound, bound, size=(10, 32, 1)).astype(np.float32)
    jstate = jclassic.PhysicsState(jax.random.split(jax.random.PRNGKey(0), 32),
                                   jax.numpy.asarray(physics), jax.numpy.zeros(32, jax.numpy.int32))
    tstate = classic.PhysicsState(torch.Generator().manual_seed(0), t(physics),
                                  torch.zeros(32, dtype=torch.int32))
    jstep = jax.jit(jax.vmap(jenv.step))
    returns = np.zeros((2, 32), np.float32)
    for step in range(10):
        jstate, jts = jstep(jstate, jax.numpy.asarray(actions[step]))
        tstate, tts = tenv.step(tstate, t(actions[step]))
        returns += np.stack([np.asarray(jts.reward), n(tts.reward)])
    np.testing.assert_allclose(n(tstate.physics), np.asarray(jstate.physics), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(returns[1], returns[0], rtol=1e-4, atol=1e-4)


def test_continuous_envs_reset_inside_their_ranges_and_register():
    from stoix_tpu_torch.envs import spaces
    from stoix_tpu_torch.envs.registry import make_single

    pendulum = make_single("Pendulum-v1")
    _, ts = pendulum.reset(torch.Generator().manual_seed(0), 256)
    cos, sin, thdot = n(ts.observation.agent_view).T
    np.testing.assert_allclose(cos**2 + sin**2, 1.0, atol=1e-6)
    assert np.all(np.abs(thdot) <= 1.0)
    assert pendulum.observation_value().agent_view.shape == (3,)
    assert pendulum.observation_value().action_mask.shape == (1,)
    car = make_single("MountainCarContinuous-v0")
    state, ts = car.reset(torch.Generator().manual_seed(0), 256)
    pos = n(state.physics)[:, 0]
    assert np.all((pos >= -0.6) & (pos <= -0.4)) and np.all(n(state.physics)[:, 1] == 0.0)
    for env, high in ((pendulum, 2.0), (car, 1.0)):
        space = env.action_space()
        assert isinstance(space, spaces.Box) and space.shape == (1,)
        assert float(space.high) == high and env.num_actions == 1
