"""Anakin SPO of the PyTorch port (stoix_tpu_torch/systems/spo/ff_spo.py,
ff_spo_continuous.py) against the JAX package's, on the CPU, at a small
width (MLPs of 16 x 16), on CartPole (envs near the pole's angle limit, so
particles terminate inside the horizon) and on Pendulum.

1. One SMC search of every env, fed the JAX package's draws (rebuilt from
   each env's search key: the root actions', each step's next actions' and
   resampling's), against `jax.vmap(_smc_search)` under `jax.jit`: the
   particles' root actions exact (Pendulum's floats 1e-6: XLA's tanh), every
   resampling decision exact (the JAX side's ESS trace read out of its
   scan) with both kinds present, the weights and the advantage sums 1e-6.
2. One acting step against the JAX package's own `_env_step` (jitted), fed
   the choice's Gumbel draws too: the executed action and the stored
   particle fields; the learner's step is the search, the choice and the
   live env's step.
3. (Two update epochs of each are in tests/test_torch_spo_update.py; the
   sweep's runs, the rollout's stores, a resume and C22's refusal in
   tests/test_torch_spo_sweep.py.)
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.systems.spo import ff_spo as jax_spo
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import OnlineAndTarget
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.search import ff_az
from stoix_tpu_torch.systems.spo import ff_spo
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from test_torch_az import cartpole_near_limits, jax_core, jax_learner, port_core, replica
from torch_parity import n, t

ROOTS = {"ff_spo": "default/anakin/default_ff_spo.yaml",
         "ff_spo_continuous": "default/anakin/default_ff_spo_continuous.yaml"}
SMALL = ["network.actor_network.pre_torso.layer_sizes=[16,16]",
         "network.critic_network.pre_torso.layer_sizes=[16,16]"]
# The JAX sweep's overrides (tests/test_systems_sweep.py:12-20, 69-76).
SWEEP = ["arch.total_num_envs=16", "arch.total_timesteps=2048", "arch.num_evaluation=1",
         "arch.num_eval_episodes=8", "arch.absolute_metric=False", "logger.use_console=False",
         "system.num_particles=8", "system.search_horizon=3", "system.rollout_length=8",
         "system.sample_sequence_length=8", "system.epochs=4"]
SWEEP_ENV = {"ff_spo": ["env=identity_game"], "ff_spo_continuous": []}
# The search tests: 12 envs of 8 particles over 4 steps, a temperature low
# enough (softplus(-1.5) = 0.20) and an ESS threshold high enough (0.85 . 8)
# that some envs resample after a step and some do not.
SEARCH = ["arch.total_num_envs=12", "system.num_particles=8", "system.search_horizon=4",
          "system.init_log_temperature=-1.5", "system.ess_threshold=0.85"]


def compose(system, overrides):
    cfg = check_total_timesteps(config_lib.compose(config_lib.default_config_dir(),
                                                   ROOTS[system], overrides), 1)
    return cfg, jax_config.compose(jax_config.default_config_dir(), ROOTS[system], overrides)


def port_networks(env, cfg, jparams):
    """The port's actor and critic carrying the JAX package's online params,
    and the port's SPOParams of the JAX package's (online and target)."""
    actor, critic = ff_ppo.build_networks(env, cfg, torch.Generator())

    def pair(module, side):
        load_flax_params(module, side.target)
        target = {k: v.detach().clone() for k, v in module.named_parameters()}
        load_flax_params(module, side.online)
        return OnlineAndTarget({k: v.detach().clone() for k, v in module.named_parameters()},
                               target)

    params = ff_spo.SPOParams(pair(actor, jparams.actor_params),
                              pair(critic, jparams.critic_params),
                              t(jparams.log_temperature), t(jparams.log_alpha))
    return actor, critic, params


def smc_draws(search_keys, num_particles, horizon, width, continuous):
    """The draws of the JAX `_smc_search` from each env's search key (the
    step's next-action draw after the last step is made and never used):
    (root [E, N, w], next [H - 1, E, N, w], resample [H, E, N, N])."""
    def draw(key):
        shape = (num_particles, width)
        return jax.random.normal(key, shape) if continuous else jax.random.gumbel(key, shape)

    def one(key):
        key, act_key = jax.random.split(key)
        nexts, resamples = [], []
        for _ in range(horizon):
            key, next_key, resample_key = jax.random.split(key, 3)
            nexts.append(draw(next_key))
            resamples.append(jax.random.gumbel(resample_key, (num_particles, num_particles)))
        return draw(act_key), jnp.stack(nexts[:-1]), jnp.stack(resamples)

    root, nxt, resample = jax.jit(jax.vmap(one))(search_keys)
    return t(root), t(np.swapaxes(nxt, 0, 1)), t(np.swapaxes(resample, 0, 1))


def jax_search_with_ess(smc_search, params, keys, states, observations):
    """`jax.vmap(_smc_search)` under `jax.jit`, with each env's ESS trace
    [H] (its scan's outputs, which the package discards) read out."""
    def one(key, state, obs):
        traces, original = [], jax.lax.scan

        def scan(f, init, xs=None, length=None, **kwargs):
            carry, ys = original(f, init, xs, length, **kwargs)
            traces.append(ys)
            return carry, ys

        jax.lax.scan = scan
        try:
            out = smc_search(params, key, state, obs)
        finally:
            jax.lax.scan = original
        return out, traces[0]

    return jax.jit(jax.vmap(one))(keys, states, observations)


def spo_jax_state(system, overrides, monkeypatch):
    """(port cfg, JAX cfg, the JAX setup's replica-0 learner state with its
    envs near their limits (CartPole), the JAX `_update_step`)."""
    cfg, jcfg = compose(system, SMALL + overrides)
    jsetup, update_step = jax_learner(jax_spo, "get_learner_fn", 4, jcfg, monkeypatch)
    state = jsetup.learner_state
    state = state._replace(params=replica(state.params), opt_states=replica(state.opt_states),
                           buffer_state=None, key=jnp.asarray(np.asarray(state.key)[0, 0]),
                           env_state=jax.tree.map(lambda x: x[0], state.env_state),
                           timestep=jax.tree.map(lambda x: x[0], state.timestep))
    if system == "ff_spo":
        state = state._replace(env_state=cartpole_near_limits(state.env_state, 2))
        obs = state.timestep.observation
        state = state._replace(timestep=state.timestep._replace(observation=obs._replace(
            agent_view=jax_core(state.env_state).physics)))
    return cfg, jcfg, state, update_step


def port_search(cfg, jstate):
    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    continuous = ff_spo.is_continuous(env)
    actor, critic, params = port_networks(env, cfg, jstate.params)
    search = ff_spo.SMCSearch(ff_az.make_simulator(cfg), (ff_ppo.make_apply_fn(actor),
                                                         ff_ppo.make_apply_fn(critic)),
                              cfg, continuous, ff_spo.action_dim(env, continuous))
    return search, params


def port_observation(obs):
    return Observation(*(t(getattr(obs, k)) for k in Observation._fields))


@pytest.mark.parametrize("system", list(ROOTS))
def test_smc_search_fed_jax_draws_matches_the_jax_search(system, monkeypatch):
    cfg, _, state, update_step = spo_jax_state(system, SEARCH, monkeypatch)
    env_step = inspect.getclosurevars(update_step).nonlocals["_env_step"]
    smc_search = inspect.getclosurevars(env_step).nonlocals["_smc_search"]
    batch = int(cfg.arch.total_num_envs)
    keys = jax.random.split(jax.random.PRNGKey(17), batch)
    core = jax_core(state.env_state)
    (actions, weights, advs), ess = jax_search_with_ess(smc_search, state.params, keys, core,
                                                        state.timestep.observation)

    search, params = port_search(cfg, state)
    root, nxt, resample = smc_draws(keys, search.num_particles, search.horizon,
                                    search.action_dim, search.continuous)
    choice = torch.zeros((batch, search.num_particles))
    sim_state = port_core(core, torch.Generator())
    out = search(params, ff_spo.SPONoise(root, nxt, resample, choice), sim_state,
                 port_observation(state.timestep.observation))

    want_resampled = (np.asarray(ess) < search.ess_floor).T  # [H, E]
    np.testing.assert_array_equal(n(out.resampled), want_resampled)
    assert want_resampled.any() and not want_resampled.all()
    if search.continuous:
        np.testing.assert_allclose(n(out.particle_actions), np.asarray(actions), rtol=0,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(n(out.particle_actions), np.asarray(actions))
    np.testing.assert_allclose(n(out.weights), np.asarray(weights), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(out.raw_advantages), np.asarray(advs), rtol=1e-6, atol=1e-6)
    # The simulator's steps and gathers leave the root state's tensors as they were.
    np.testing.assert_array_equal(n(sim_state.step_count), np.asarray(core.step_count))
    if system == "ff_spo":
        assert float(np.asarray(core.step_count).max()) > 0  # envs near the step limit


@pytest.mark.parametrize("system", list(ROOTS))
def test_acting_step_fed_jax_draws_matches_the_jax_env_step(system, monkeypatch):
    cfg, _, state, update_step = spo_jax_state(system, SEARCH, monkeypatch)
    env_step = inspect.getclosurevars(update_step).nonlocals["_env_step"]
    _, want = jax.jit(env_step)(state, None)

    search, params = port_search(cfg, state)
    batch = int(cfg.arch.total_num_envs)
    _, search_key, choice_key = jax.random.split(state.key, 3)
    draws = smc_draws(jax.random.split(search_key, batch), search.num_particles,
                      search.horizon, search.action_dim, search.continuous)
    noise = ff_spo.SPONoise(*draws, t(jax.random.gumbel(choice_key,
                                                        (batch, search.num_particles))))
    action, extras = ff_spo.SPOActing(search).act(
        params, noise, port_core(jax_core(state.env_state), torch.Generator()),
        port_observation(state.timestep.observation))
    atol = 1e-6 if search.continuous else 0.0
    np.testing.assert_allclose(n(action), np.asarray(want["action"]), rtol=0, atol=atol)
    np.testing.assert_allclose(n(extras["particle_actions"]),
                               np.asarray(want["particle_actions"]), rtol=0, atol=atol)
    np.testing.assert_allclose(n(extras["particle_weights"]),
                               np.asarray(want["particle_weights"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(extras["particle_advs"]), np.asarray(want["particle_advs"]),
                               rtol=1e-6, atol=1e-6)
    # The executed action is the chosen particle's root action.
    got_actions = n(extras["particle_actions"])
    assert any(np.array_equal(n(action)[e], got_actions[e, i])
               for e in range(batch) for i in range(search.num_particles))


def test_learner_env_step_is_the_search_the_choice_and_the_env_step():
    """Fed noise, the step searches from the envs' core states with the
    replica's generator in place of the env's (C21), executes the chosen
    particle's root action and stores the step."""
    cfg, _ = compose("ff_spo", SMALL + SWEEP + SWEEP_ENV["ff_spo"])
    setup = ff_spo.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 5)
    learner, state = setup.learn, setup.learner_state
    noise = learner.acting.draw_noise(torch.Generator().manual_seed(0), 16)
    step_copy = torch.Generator().set_state(state.generator.get_state())
    new_state, data = learner.env_step(state, [noise])
    sim_state = ff_az.simulator_state(state.env_state, 0, 1, step_copy)
    action, extras = learner.acting.act(state.params, noise, sim_state,
                                        state.timestep.observation)
    assert torch.equal(data["action"], action)
    for key, value in extras.items():
        assert torch.equal(data[key], value), key
    assert set(data) == {"done", "truncated", "action", "particle_actions", "particle_weights",
                         "particle_advs", "reward", "obs", "next_obs", "info"}
    assert data["particle_actions"].shape == (16, 8) and data["done"].dtype == torch.float32
    np.testing.assert_allclose(n(data["particle_weights"].sum(-1)), 1.0, rtol=1e-6)
    target = ff_az.unwrap_env_state(state.env_state).target
    assert torch.equal(data["reward"], (action == target).to(torch.float32))
    assert torch.equal(state.generator.get_state(), step_copy.get_state())
    assert new_state.timestep is not state.timestep

