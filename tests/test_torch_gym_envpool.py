"""The port's gymnasium and envpool adapters, its stateful evaluator and the
Sebulba systems that take them, against the JAX package on the CPU.

1. `VecGymToStoix` against the JAX package's on gymnasium CartPole-v1 pools
   built by each package's `GymnasiumFactory` from the same seed, reset with
   the same seed and stepped with the same actions for 200 steps across
   episode ends: every field of every TimeStep exact, dtypes included.
2. `EnvPoolAdapter` against the JAX package's on tests/test_envpool_adapter.py's
   `FakeEnvPool` (with lives, without, and a pixel-shaped pool) over the same
   action sequence: every field exact; then that file's five behaviour
   oracles on the port's adapter (reset and spaces, the done-ids splice, the
   lives gate, the elapsed-step truncation, a pool without lives), and
   `close`.
3. `get_stateful_evaluator_fn` against the JAX package's on envpool-adapted
   fake pools with a fixed act function: the returns equal, the host-step
   cap honoured (the pool stepped exactly `eval_max_steps` times), and the
   `nan` when no episode concludes.
4. Sebulba ff_ppo with `network=cnn` and Sebulba ff_dqn through the envpool
   adapter on a fake Atari task id that has no tensor-env twin, at the JAX
   slow test's shape (8 envs, 2 048 steps, 4 eval episodes; ff_dqn with 2
   epochs a learn step and a fill of 128 before it samples): both evaluate
   through `get_stateful_evaluator_fn` (never the registry evaluator), with
   a finite, positive return (every fake step pays +1) and no actor crash,
   restart or evaluator error.
"""

import math

import numpy as np
import pytest
import torch

from stoix_tpu.envs.envpool_adapter import EnvPoolAdapter as JaxEnvPoolAdapter
from stoix_tpu.envs.gymnasium_adapter import GymnasiumFactory as JaxGymnasiumFactory
from stoix_tpu.evaluator import get_stateful_evaluator_fn as jax_stateful_evaluator
from stoix_tpu_torch import evaluator as port_evaluator
from stoix_tpu_torch.envs.envpool_adapter import EnvPoolAdapter
from stoix_tpu_torch.envs.factory import EnvFactory
from stoix_tpu_torch.envs.gymnasium_adapter import GymnasiumFactory
from stoix_tpu_torch.systems.ppo.sebulba import ff_ppo
from stoix_tpu_torch.systems.q_learning.sebulba import ff_dqn
from stoix_tpu_torch.utils import config as config_lib
from test_envpool_adapter import FakeEnvPool

TORCH_DTYPES = {torch.float32: np.float32, torch.float64: np.float64, torch.int8: np.int8,
                torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_}


def _flat(timestep):
    """{path: array} of every field of a TimeStep (tensors or arrays)."""
    out = {}

    def walk(prefix, x):
        if hasattr(x, "_fields"):
            for name, value in zip(x._fields, x):
                walk(f"{prefix}{name}.", value)
        elif isinstance(x, dict):
            for name, value in x.items():
                walk(f"{prefix}{name}.", value)
        else:
            out[prefix.rstrip(".")] = x

    walk("", timestep)
    return out


def assert_timesteps_equal(port, ref):
    got, want = _flat(port), _flat(ref)
    assert got.keys() == want.keys()
    for name, value in got.items():
        assert isinstance(value, torch.Tensor) and value.device.type == "cpu", name
        expect = np.asarray(want[name])
        assert TORCH_DTYPES[value.dtype] == expect.dtype, name
        np.testing.assert_array_equal(value.numpy(), expect, err_msg=name)


# ---------------------------------------------------------------- gymnasium


def test_vec_gym_to_stoix_matches_jax_over_200_steps():
    pytest.importorskip("gymnasium")
    port_env, jax_env = (factory("CartPole-v1", 7)(4)
                         for factory in (GymnasiumFactory, JaxGymnasiumFactory))
    assert port_env.num_envs == jax_env.num_envs == 4
    assert port_env.num_actions == jax_env.num_actions == 2
    assert port_env.action_space().num_values == jax_env.action_space().num_values
    assert port_env.observation_value().agent_view.shape == (4,)
    assert_timesteps_equal(port_env.reset(seed=3), jax_env.reset(seed=3))
    rng = np.random.default_rng(0)
    ends = 0
    for _ in range(200):
        action = rng.integers(0, 2, size=4)
        port_ts = port_env.step(torch.as_tensor(action))
        jax_ts = jax_env.step(action)
        assert_timesteps_equal(port_ts, jax_ts)
        ends += int(port_ts.last().sum())
    assert ends >= 4  # across several episode ends
    port_env.close()


# ---------------------------------------------------------------- envpool


POOLS = {"lives": (dict(), True), "no_lives": (dict(lives=1), False),
         "pixels": (dict(num_envs=3, obs_shape=(8, 8, 2)), None)}


@pytest.mark.parametrize("pool", list(POOLS))
def test_envpool_adapter_matches_jax_over_an_action_sequence(pool):
    kwargs, has_lives = POOLS[pool]
    port_env = EnvPoolAdapter(FakeEnvPool(**kwargs), has_lives=has_lives)
    jax_env = JaxEnvPoolAdapter(FakeEnvPool(**kwargs), has_lives=has_lives)
    assert port_env._has_lives == jax_env._has_lives
    assert port_env.observation_value().agent_view.shape == jax_env._obs_shape
    assert_timesteps_equal(port_env.reset(), jax_env.reset())
    rng = np.random.default_rng(1)
    for _ in range(40):
        action = rng.integers(0, 5, size=port_env.num_envs)
        assert_timesteps_equal(port_env.step(torch.as_tensor(action)), jax_env.step(action))


def test_reset_and_spaces():
    env = EnvPoolAdapter(FakeEnvPool(), has_lives=True)
    assert env.num_envs == 4
    ts = env.reset()
    assert ts.observation.agent_view.shape == (4, 2)
    assert ts.extras["episode_metrics"]["episode_return"].tolist() == [0, 0, 0, 0]
    assert env.action_space().num_values == 5


def test_done_ids_autoreset_splices_reset_obs():
    env = EnvPoolAdapter(FakeEnvPool(), has_lives=True)
    env.reset()
    a = np.zeros(4, np.int32)
    env.step(a)
    env.step(a)
    ts = env.step(a)  # envs 0-2 lose a life (terminate)
    assert bool(ts.last()[0]) and not bool(ts.last()[3])
    assert ts.discount[0] == 0.0 and ts.discount[3] == 1.0
    assert ts.extras["next_obs"].agent_view[0, 0] == 0.0  # the true terminal successor
    assert ts.observation.step_count[0] == 0  # the spliced reset observation


def test_lives_gate_episode_metrics():
    env = EnvPoolAdapter(FakeEnvPool(), has_lives=True)
    env.reset()
    a = np.zeros(4, np.int32)
    for _ in range(3):
        ts = env.step(a)
    assert bool(ts.last()[0])
    assert not bool(ts.extras["episode_metrics"]["is_terminal_step"][0])
    assert ts.extras["episode_metrics"]["episode_return"][0] == 0.0
    for _ in range(3):
        ts = env.step(a)
    assert bool(ts.extras["episode_metrics"]["is_terminal_step"][0])
    assert ts.extras["episode_metrics"]["episode_return"][0] == 6.0
    assert ts.extras["episode_metrics"]["episode_length"][0] == 6


def test_elapsed_step_truncation():
    env = EnvPoolAdapter(FakeEnvPool(), has_lives=True)
    env.reset()
    a = np.zeros(4, np.int32)
    for _ in range(6):
        ts = env.step(a)
    assert bool(ts.last()[3]) and bool(ts.extras["truncation"][3]) and ts.discount[3] == 1.0


def test_no_lives_pool_concludes_on_done():
    env = EnvPoolAdapter(FakeEnvPool(lives=1), has_lives=False)
    env.reset()
    a = np.zeros(4, np.int32)
    for _ in range(3):
        ts = env.step(a)
    assert bool(ts.extras["episode_metrics"]["is_terminal_step"][0])
    assert ts.extras["episode_metrics"]["episode_return"][0] == 3.0


def test_close_closes_the_pool():
    class Closing(FakeEnvPool):
        closed = False

        def close(self):
            Closing.closed = True

    EnvPoolAdapter(Closing(), has_lives=True).close()
    assert Closing.closed


# ---------------------------------------------------------------- the stateful evaluator


class CountingPool(FakeEnvPool):
    steps = 0

    def step(self, action, env_ids=None):
        if env_ids is None:
            CountingPool.steps += 1
        return super().step(action, env_ids)


def _pool_factory(adapter):
    def factory(num_envs):
        return adapter(CountingPool(num_envs=num_envs), has_lives=True)

    return factory


def _eval_config(extra=()):
    return config_lib.compose(config_lib.default_config_dir(),
                              "default/sebulba/default_ff_ppo.yaml",
                              ["arch.num_eval_episodes=16", *extra])


def _fixed_actions(params, observation, generator):
    # The action depends on the observation only: envs act alike in both packages.
    return (torch.as_tensor(observation.agent_view)[:, 0] % 5).to(torch.int32)


def _jax_fixed_actions(params, observation, key):
    import jax.numpy as jnp

    return (jnp.asarray(observation.agent_view)[:, 0] % 5).astype(jnp.int32)


@pytest.mark.parametrize("cap,host_steps", [(None, 6), (40, 6), (5, 5)])
def test_stateful_evaluator_matches_jax(cap, host_steps):
    import jax

    extra = [] if cap is None else [f"arch.eval_max_steps={cap}"]
    cfg = _eval_config(extra)
    port = port_evaluator.get_stateful_evaluator_fn(_pool_factory(EnvPoolAdapter),
                                                    _fixed_actions, cfg)
    ref = jax_stateful_evaluator(_pool_factory(JaxEnvPoolAdapter), _jax_fixed_actions,
                                 _eval_config(extra))
    CountingPool.steps = 0
    got = port(None, torch.Generator().manual_seed(0))["episode_return"]
    assert CountingPool.steps == host_steps
    want = np.asarray(ref(None, jax.random.PRNGKey(0))["episode_return"])
    assert got.dtype == torch.float32 and got.shape == want.shape
    if cap == 5:
        # No episode concludes within the cap (the first game ends at step 6): nan.
        assert got.shape == (1,) and math.isnan(float(got[0])) and np.isnan(want).all()
    else:
        assert got.shape == (16,)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- Sebulba through the adapter


SEBULBA = ["env=identity_game", "env.scenario.name=FakeAtari-v5", "arch.total_num_envs=8",
           "arch.total_timesteps=2048", "arch.num_evaluation=1", "arch.num_eval_episodes=4",
           "system.rollout_length=8", "arch.actor.device_ids=[0]",
           "arch.actor.actor_per_device=2", "arch.learner.device_ids=[0]",
           "logger.use_console=False"]


class FakeEnvPoolFactory(EnvFactory):
    def __call__(self, num_envs: int) -> EnvPoolAdapter:
        self._next_seed(num_envs)
        return EnvPoolAdapter(FakeEnvPool(num_envs=num_envs, obs_shape=(8, 8, 2)),
                              has_lives=True)


@pytest.mark.parametrize("system,overrides", [
    ("ff_ppo", ["network=cnn", "system.multistep_impl=pallas"]),
    ("ff_dqn", ["network=cnn_dqn", "system.total_buffer_size=1024",
                "system.total_batch_size=32", "system.epochs=2",
                "system.replay.min_fill=128"]),
])
def test_sebulba_through_the_envpool_adapter_evaluates_on_a_pool(system, overrides,
                                                                 monkeypatch):
    module = {"ff_ppo": ff_ppo, "ff_dqn": ff_dqn}[system]
    monkeypatch.setattr(module, "make_factory", lambda cfg: FakeEnvPoolFactory("fake", 0))
    made = []
    stateful = port_evaluator.get_stateful_evaluator_fn

    def recording(*args, **kwargs):
        made.append(args[0])
        return stateful(*args, **kwargs)

    monkeypatch.setattr(ff_ppo, "get_stateful_evaluator_fn", recording)
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             f"default/sebulba/default_{system}.yaml", SEBULBA + overrides)
    ret = module.run_experiment(cfg, device="cpu")
    assert len(made) == 1  # the pool's evaluator, not the registry's
    assert math.isfinite(ret) and ret > 0
    stats = module.LAST_RUN_STATS
    resilience = stats["resilience"]
    assert (resilience["actor_crashes"], resilience["actor_restarts"],
            resilience["evaluator_errors"]) == (0, 0, 0)
