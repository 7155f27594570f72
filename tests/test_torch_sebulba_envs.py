"""Sebulba's env seam in the PyTorch port: the native C++ pool and the
stateful wrapper over the port's tensor envs.

1. The port's `envs/native/cvec.cpp` is byte-for-byte the JAX package's,
   and the port builds it into `stoix_tpu_torch/_build/`, never beside it.
2. The port's CVecPool and the JAX package's on the same seeds and actions:
   every field of every timestep exact, for every game of the pool.
3. The pool's CartPole and Pendulum in lockstep with the port's tensor twins
   from the pool's states (tests/test_sebulba.py:69-97,
   tests/test_cvec_continuous.py): CartPole 1e-5, Pendulum 2e-4 (the pool
   steps Pendulum in its own float order; the JAX test's bar).
4. `TensorToStateful` over the port's CartPole and IdentityGame against the
   JAX package's `JaxToStateful`, the port's env fed the draws JAX made
   (its reset states and, for IdentityGame, each step's targets), over
   episode ends with auto-reset: exact, CartPole's physics at 1e-5.
5. `make_factory` by `env.backend`: the tensor envs, the native pool, and
   the gymnasium and envpool adapters (tests/test_torch_gym_envpool.py
   holds the adapters against the JAX package's).
"""

import filecmp
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.envs import cvec as jcvec
from stoix_tpu.envs import debug as jdebug
from stoix_tpu.envs.classic import CartPole as JCartPole
from stoix_tpu.envs.factory import JaxToStateful
from stoix_tpu_torch.envs import classic, cvec, debug
from stoix_tpu_torch.envs.factory import (
    EnvPoolFactory, TensorEnvFactory, TensorToStateful, make_factory,
)
from stoix_tpu_torch.envs.gymnasium_adapter import GymnasiumFactory, VecGymToStoix
from stoix_tpu_torch.utils import config as config_lib
from torch_parity import n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cvec_source_is_the_jax_packages_byte_for_byte():
    assert filecmp.cmp(cvec.SOURCE, os.path.join(REPO, "stoix_tpu", "envs", "native", "cvec.cpp"),
                       shallow=False)
    path = cvec.ensure_built()
    assert os.path.dirname(path) == os.path.join(REPO, "stoix_tpu_torch", "_build")
    assert not os.path.exists(os.path.join(os.path.dirname(cvec.SOURCE), "libcvec.so"))


GAMES = {"CartPole-v1": 8, "Pendulum-v1": 4, "Breakout-minatar": 4, "Asterix-minatar": 4,
         "Freeway-minatar": 4, "SpaceInvaders-minatar": 4, "Breakout-atari": 2}


def _fields(ts):
    metrics = ts.extras["episode_metrics"]
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in (
        ts.step_type, ts.reward, ts.discount, *ts.observation, *ts.extras["next_obs"],
        ts.extras["truncation"], metrics["episode_return"], metrics["episode_length"],
        metrics["is_terminal_step"])]


@pytest.mark.parametrize("game", list(GAMES))
def test_pool_matches_the_jax_pool(game):
    num_envs = GAMES[game]
    steps = 40 if game == "Breakout-atari" else 300
    port = cvec.CVecPool(game, num_envs, seed=5, max_steps=60)
    ref = jcvec.CVecPool(game, num_envs, seed=5, max_steps=60)
    rng = np.random.default_rng(0)
    ends = 0
    for step in range(steps + 1):
        if step == 0:
            got, want = port.reset(), ref.reset()
        elif port.action_space().shape:
            action = rng.uniform(-2.0, 2.0, size=(num_envs, 1)).astype(np.float32)
            got, want = port.step(torch.from_numpy(action)), ref.step(action)
        else:
            action = rng.integers(0, port.num_actions, size=num_envs).astype(np.int32)
            got, want = port.step(torch.from_numpy(action)), ref.step(action)
        for a, b in zip(_fields(got), _fields(want)):
            np.testing.assert_array_equal(a, b)
        ends += int(np.asarray(want.step_type == 2).sum())
    assert ends > 0 or game == "Breakout-atari"
    assert port.num_actions == ref.num_actions
    assert port.observation_value().agent_view.shape == ref._obs_shape


def test_pool_cartpole_in_lockstep_with_the_port_twin():
    pool = cvec.CVecCartPole(1, seed=123)
    ts = pool.reset()
    env = classic.CartPole()
    state, _ = env.reset_from_draws(ts.observation.agent_view.clone(), torch.Generator())
    for a in [1, 0, 1, 1, 0, 1, 0, 0]:
        ts_pool = pool.step(np.asarray([a], np.int32))
        state, ts_env = env.step(state, torch.tensor([a]))
        np.testing.assert_allclose(n(ts_pool.extras["next_obs"].agent_view),
                                   n(ts_env.observation.agent_view), rtol=1e-5)
        assert bool(ts_pool.discount[0] == 0.0) == bool(ts_env.discount[0] == 0.0)


def test_pool_pendulum_in_lockstep_with_the_port_twin():
    pool = cvec.CVecPool("Pendulum-v1", num_envs=4, seed=7, max_steps=200)
    obs = n(pool.reset().observation.agent_view)  # [4, 3]: cos, sin, thdot
    env = classic.Pendulum()
    physics = torch.from_numpy(np.stack([np.arctan2(obs[:, 1], obs[:, 0]), obs[:, 2]], -1))
    state, _ = env.reset_from_draws(physics.to(torch.float32), torch.Generator())
    rng = np.random.default_rng(3)
    for step in range(50):
        torque = rng.uniform(-2.0, 2.0, size=(4, 1)).astype(np.float32)
        ts_pool = pool.step(torque)
        state, ts_env = env.step(state, torch.from_numpy(torque))
        np.testing.assert_allclose(n(ts_pool.observation.agent_view),
                                   n(ts_env.observation.agent_view), atol=2e-4, rtol=2e-4,
                                   err_msg=f"diverged at step {step}")
        np.testing.assert_allclose(n(ts_pool.reward), n(ts_env.reward), atol=2e-4, rtol=2e-4)


class _FedCartPole(classic.CartPole):
    """The port's CartPole drawing its reset physics from a queue."""

    def __init__(self, queue, max_steps):
        super().__init__(max_steps=max_steps)
        self.queue = queue

    def _init_physics(self, generator, num_envs):
        return self.queue.pop(0)


class _FedIdentity(debug.IdentityGame):
    """The port's IdentityGame drawing its targets from a queue."""

    def __init__(self, queue):
        super().__init__()
        self.queue = queue

    def _draw_targets(self, generator, num_envs):
        return self.queue.pop(0)


def _assert_same(got, want, atol):
    for a, b in zip(_fields(got), [np.asarray(x) for x in _fields_jax(want)]):
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=atol, rtol=atol)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype))


def _fields_jax(ts):
    metrics = ts.extras["episode_metrics"]
    return (ts.step_type, ts.reward, ts.discount, *ts.observation, *ts.extras["next_obs"],
            ts.extras["truncation"], metrics["episode_return"], metrics["episode_length"],
            metrics["is_terminal_step"])


@pytest.mark.parametrize("game", ["CartPole", "IdentityGame"])
def test_stateful_wrapper_matches_jax_to_stateful(game):
    num_envs, steps = 8, 60
    queue = []
    if game == "CartPole":
        ref = JaxToStateful(JCartPole(max_steps=25), num_envs, seed=3)
        port_env = _FedCartPole(queue, max_steps=25)

        def reset_draws():  # the physics of every env's current episode
            return torch.from_numpy(np.array(ref._state.inner.inner.physics))

        step_draws = None
        atol = 1e-5
    else:
        ref = JaxToStateful(jdebug.IdentityGame(), num_envs, seed=3)
        port_env = _FedIdentity(queue)

        def reset_draws():  # every env's current target
            return torch.from_numpy(np.array(ref._state.inner.inner.target)).long()

        def step_draws(ts):  # the targets each step drew, before any reset
            return torch.from_numpy(np.asarray(ts.extras["next_obs"].agent_view).argmax(-1))

        atol = 0.0
    port = TensorToStateful(port_env, num_envs, seed=3)
    want = ref.reset()
    queue.append(reset_draws())
    _assert_same(port.reset(), want, atol)
    rng = np.random.default_rng(1)
    ends = 0
    for _ in range(steps):
        action = rng.integers(0, 2, size=num_envs)
        want = ref.step(jnp.asarray(action, jnp.int32))
        if step_draws is not None:
            queue.append(step_draws(want))
        queue.append(reset_draws())  # the ended envs' new episodes
        _assert_same(port.step(torch.from_numpy(action)), want, atol)
        assert not queue
        ends += int(np.asarray(want.step_type == 2).sum())
    assert ends >= num_envs


def test_factories_hand_out_unique_seeds_and_default_to_the_cpu():
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/sebulba/default_ff_ppo.yaml", ["env=identity_game"])
    factory = make_factory(config)
    assert isinstance(factory, TensorEnvFactory)
    first, second = factory(4), factory(4)
    assert first.device == second.device == torch.device("cpu")
    assert factory._next_seed(1) == int(config.arch.seed) + 8
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/sebulba/default_ff_ppo.yaml", ["env=breakout"])
    pool = make_factory(config)(2)
    assert isinstance(pool, cvec.CVecPool) and pool.num_actions == 3


@pytest.mark.parametrize("backend", ["gymnasium", "envpool"])
def test_backends_build_their_adapters(backend):
    """`env.backend` gymnasium and envpool build the port's adapters (they
    were refused before A15b); envpool's factory raises the JAX package's
    missing-package error where `envpool` is not installed."""
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/sebulba/default_ff_ppo.yaml",
                                [f"env.backend={backend}", "env.scenario.name=CartPole-v1"])
    factory = make_factory(config)
    if backend == "gymnasium":
        pytest.importorskip("gymnasium")
        assert isinstance(factory, GymnasiumFactory)
        envs = factory(2)
        assert isinstance(envs, VecGymToStoix) and envs.num_actions == 2
        assert envs.reset(seed=0).observation.agent_view.shape == (2, 4)
        envs.close()
    else:
        assert isinstance(factory, EnvPoolFactory)
        if importlib.util.find_spec("envpool") is None:
            with pytest.raises(ImportError, match="requires the optional 'envpool' package"):
                factory(2)
