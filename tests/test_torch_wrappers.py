"""The env wrappers and evaluation-reset hooks of the PyTorch port against the
JAX package's, on explicit states (oracles: tests/test_envs.py's wrapper
tests and tests/test_specialised.py::TestTiledEvalReset).

- CachedAutoResetWrapper replays each env's initial state, and the replayed
  episodes draw fresh targets;
- OptimisticResetVmapWrapper restarts every ended env from one of
  num_envs / reset_ratio reset states, and refuses a ratio that does not
  divide num_envs;
- FlattenObservationWrapper flattens a grid agent_view everywhere, under the
  core stack too;
- the registry wires each from `env.wrapper`;
- `env.eval_reset_fn` with `make_tiled_eval_reset_fn` tiles IdentityGame's
  levels across episodes (the same returns as the JAX evaluator), and the
  default reset is unaffected.
All comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.envs import debug as jdebug
from stoix_tpu.envs import wrappers as jwrappers
from stoix_tpu.envs.registry import make_single as jax_make_single
from stoix_tpu.evaluator import get_ff_evaluator_fn as jax_ff_evaluator
from stoix_tpu.parallel import create_mesh
from stoix_tpu.utils.config import Config as JaxConfig
from stoix_tpu_torch import envs
from stoix_tpu_torch.envs import debug, spaces, wrappers
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.evaluator import get_ff_evaluator_fn, get_rnn_evaluator_fn
from stoix_tpu_torch.utils.config import Config
from torch_parity import n, t

N = 8


def test_cached_auto_reset_replays_the_initial_state_as_jax_does():
    jenv = jwrappers.VmapWrapper(jwrappers.CachedAutoResetWrapper(jdebug.IdentityGame(4, 2)))
    jstate, jts = jenv.reset(jax.random.split(jax.random.PRNGKey(0), N))
    tenv = wrappers.CachedAutoResetWrapper(debug.IdentityGame(4, 2))
    inner = debug.IdentityState(torch.Generator().manual_seed(0),
                                t(jstate.inner.target, torch.int64), t(jstate.inner.step_count))
    obs = Observation(t(jts.observation.agent_view), t(jts.observation.action_mask),
                      t(jts.observation.step_count))
    tstate = wrappers.CachedAutoResetState(inner, inner, obs)
    initial = np.asarray(jts.observation.agent_view)
    for _ in range(2):
        jstate, jts = jenv.step(jstate, jnp.ones((N,), jnp.int32))
        tstate, tts = tenv.step(tstate, torch.ones(N, dtype=torch.int64))
    assert bool(jnp.all(jts.last())) and bool(tts.last().all())
    # Both replay the episode-initial observation, and the step counts restart.
    np.testing.assert_array_equal(np.asarray(jts.observation.agent_view), initial)
    np.testing.assert_array_equal(n(tts.observation.agent_view), initial)
    np.testing.assert_array_equal(n(tstate.inner.step_count), 0)
    np.testing.assert_array_equal(n(tts.extras["next_obs"].step_count), 2)


def test_cached_auto_reset_draws_fresh_targets_in_replayed_episodes():
    env = wrappers.CachedAutoResetWrapper(debug.IdentityGame(4, 6))
    state, _ = env.reset(torch.Generator().manual_seed(0), 1)
    episodes = []
    for _ in range(3):
        seq = []
        for _ in range(6):
            state, ts = env.step(state, torch.zeros(1, dtype=torch.int64))
            seq.append(int(ts.extras["next_obs"].agent_view.argmax()))
        episodes.append(tuple(seq))
    assert len(set(episodes)) > 1


def test_optimistic_reset_restarts_every_ended_env_as_jax_does():
    jenv = jwrappers.OptimisticResetVmapWrapper(
        jwrappers.RecordEpisodeMetrics(jax_make_single("IdentityGame", episode_length=2)),
        num_envs=N, reset_ratio=4)
    jstate, jts = jenv.reset(jax.random.split(jax.random.PRNGKey(0), N))
    tenv = wrappers.OptimisticResetVmapWrapper(
        wrappers.RecordEpisodeMetrics(debug.IdentityGame(4, 2)), num_envs=N, reset_ratio=4)
    tstate, tts = tenv.reset(torch.Generator().manual_seed(0), N)
    for _ in range(2):
        jstate, jts = jenv.step(jstate, jnp.zeros((N,), jnp.int32))
        tstate, tts = tenv.step(tstate, torch.zeros(N, dtype=torch.int64))
    for ts, arr in ((jts, np.asarray), (tts, n)):
        assert np.all(arr(ts.last()))
        assert np.all(arr(ts.observation.step_count) == 0)
        assert np.all(arr(ts.extras["next_obs"].step_count) == 2)
    # N / reset_ratio = 2 reset states: env i restarts from slot i % 2.
    view = n(tts.observation.agent_view)
    np.testing.assert_array_equal(view[0::2], np.broadcast_to(view[0], view[0::2].shape))
    np.testing.assert_array_equal(view[1::2], np.broadcast_to(view[1], view[1::2].shape))
    np.testing.assert_array_equal(n(tstate.inner.episode_return), 0.0)


def test_optimistic_reset_refuses_a_ratio_that_does_not_divide():
    with pytest.raises(ValueError, match="divisible by reset_ratio"):
        jwrappers.OptimisticResetVmapWrapper(jax_make_single("IdentityGame"), num_envs=6,
                                             reset_ratio=4)
    with pytest.raises(ValueError, match="divisible by reset_ratio"):
        wrappers.OptimisticResetVmapWrapper(debug.IdentityGame(), num_envs=6, reset_ratio=4)


class GridIdentity(debug.IdentityGame):
    """IdentityGame whose agent_view is a 2 x 2 grid (a structured view)."""

    def observation_space(self):
        return super().observation_space()._replace(agent_view=spaces.Array((2, 2),
                                                                            torch.float32))

    def _obs(self, state):
        obs = super()._obs(state)
        return obs._replace(agent_view=obs.agent_view.reshape(-1, 2, 2))


def test_flatten_observation_everywhere_and_under_the_core_stack():
    env = wrappers.FlattenObservationWrapper(GridIdentity(4, 3))
    assert env.observation_space().agent_view.shape == (4,)
    assert env.observation_value().agent_view.shape == (4,)
    state, ts = env.reset(torch.Generator().manual_seed(0), N)
    assert ts.observation.agent_view.shape == (N, 4)
    grid = GridIdentity(4, 3)._obs(state).agent_view
    np.testing.assert_array_equal(n(ts.observation.agent_view), n(grid).reshape(N, 4))
    stacked = wrappers.apply_core_wrappers(wrappers.FlattenObservationWrapper(GridIdentity(4, 3)))
    state, ts = stacked.reset(torch.Generator().manual_seed(0), N)
    for _ in range(3):
        state, ts = stacked.step(state, torch.zeros(N, dtype=torch.int64))
    assert ts.observation.agent_view.shape == ts.extras["next_obs"].agent_view.shape == (N, 4)


@pytest.mark.parametrize("wrapper,kind", [
    ("use_cached_auto_reset=true", wrappers.CachedAutoResetWrapper),
    ("use_optimistic_reset=true", wrappers.OptimisticResetVmapWrapper),
    ("max_episode_steps=5", wrappers.AutoResetWrapper),
])
def test_registry_wires_the_wrappers(wrapper, kind):
    config = Config.from_dict({
        "env": {"scenario": {"name": "IdentityGame"}, "kwargs": {}, "wrapper": {}},
        "arch": {"total_num_envs": 32},
    })
    key, value = wrapper.split("=")
    config.env.wrapper[key] = True if value == "true" else int(value)
    train_env, eval_env = envs.make(config)
    assert isinstance(train_env, kind)
    assert isinstance(eval_env, wrappers.RecordEpisodeMetrics)
    state, ts = train_env.reset(torch.Generator().manual_seed(0), 32)
    state, ts = train_env.step(state, torch.zeros(32, dtype=torch.int64))
    assert ts.extras["next_obs"].agent_view.shape == (32, 4)
    config.env.wrapper = {"use_optimistic_reset": True, "reset_ratio": 5}
    with pytest.raises(ValueError, match="divisible"):
        envs.make(config)


# ------------------------------------------------------------------ eval reset


def _eval_config(hook=None):
    env = {} if hook is None else {"eval_reset_fn": hook}
    return {"arch": {"num_eval_episodes": 8, "evaluation_greedy": False}, "env": env}


def test_tiled_eval_levels_match_the_jax_evaluator():
    # A play-action-0 policy scores episode_length on level 0 and 0 on level 1:
    # with levels [0, 1] tiled over 8 episodes, exactly half solve.
    episode_length = 6
    jax_hook = {"_target_": "stoix_tpu.evaluator.make_tiled_eval_reset_fn", "levels": [0, 1]}
    jax_eval = jax_ff_evaluator(
        jwrappers.RecordEpisodeMetrics(jdebug.IdentityGame(4, episode_length)),
        lambda params, observation, key: jnp.zeros((), jnp.int32),
        JaxConfig.from_dict(_eval_config(jax_hook)), create_mesh({"data": -1}))
    want = np.asarray(jax_eval({}, jax.random.PRNGKey(0))["episode_return"])
    hook = {"_target_": "stoix_tpu_torch.evaluator.make_tiled_eval_reset_fn", "levels": [0, 1]}
    env = wrappers.RecordEpisodeMetrics(debug.IdentityGame(4, episode_length))
    evaluator = get_ff_evaluator_fn(
        env, lambda params, observation, gen: torch.zeros(observation.agent_view.shape[0],
                                                          dtype=torch.int64),
        Config.from_dict(_eval_config(hook)))
    got = n(evaluator({}, torch.Generator().manual_seed(0))["episode_return"])
    np.testing.assert_array_equal(np.sort(got), np.sort(want))
    np.testing.assert_array_equal(got, np.tile([float(episode_length), 0.0], 4))


def test_the_stateful_evaluator_takes_the_eval_reset_fn():
    hook = {"_target_": "stoix_tpu_torch.evaluator.make_tiled_eval_reset_fn", "levels": [1]}
    env = wrappers.RecordEpisodeMetrics(debug.IdentityGame(4, 3))

    def act(params, hstate, observation, done, gen):
        return hstate, torch.ones(observation.agent_view.shape[0], dtype=torch.int64)

    evaluator = get_rnn_evaluator_fn(env, act, Config.from_dict(_eval_config(hook)),
                                     lambda episodes: torch.zeros(episodes))
    np.testing.assert_array_equal(n(evaluator({}, torch.Generator())["episode_return"]), 3.0)


def test_default_reset_is_unaffected_by_the_hook_machinery():
    env = wrappers.RecordEpisodeMetrics(debug.IdentityGame(4, 4))
    evaluator = get_ff_evaluator_fn(
        env, lambda params, observation, gen: observation.agent_view.argmax(-1),
        Config.from_dict(_eval_config()))
    np.testing.assert_array_equal(n(evaluator({}, torch.Generator().manual_seed(0))[
        "episode_return"]), 4.0)


def two_argument_hook(env, key):
    return env.reset(key, 1)


def test_a_two_argument_hook_is_refused():
    hook = {"_target_": "test_torch_wrappers.two_argument_hook", "_partial_": True}
    env = wrappers.RecordEpisodeMetrics(debug.IdentityGame(4, 4))
    with pytest.raises(NotImplementedError, match="eval_reset_fn"):
        get_ff_evaluator_fn(env, None, Config.from_dict(_eval_config(hook)))
