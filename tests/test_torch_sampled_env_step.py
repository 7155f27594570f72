"""One searched env step of Sampled AlphaZero and Sampled MuZero of the
PyTorch port against the JAX package's own `_env_step` (jitted), on the CPU,
at small widths, on Pendulum, fed the JAX package's draws: the root set's K
normals, the blend's uniforms, the search's Dirichlet and Gumbel noise, and
the per-node normals that each simulation's key splits into K draws
([S, E, K, A], rebuilt from the key tree,
test_torch_sampled_search.py::sampled_draws): the sampled sets 1e-5, the
chosen actions 1e-5, the visit weights exactly, the root values 1e-5
relative (ff_sampled_mz's decoded values 2e-4 absolute)."""

import inspect

import jax
import numpy as np
import pytest
import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.search import ff_az, ff_sampled_az, ff_sampled_mz
from test_torch_az import jax_core, jax_learner, port_actor_critic, port_core
from test_torch_sampled_search import (
    JAX_MODULES, K, ROOTS, SIMULATIONS, SMALL, compose, mz_networks, one_replica_state,
    sampled_draws,
)
from torch_parity import n, t


@pytest.mark.parametrize("system", list(ROOTS))
def test_one_env_step_fed_jax_draws_matches_the_jax_env_step(system, monkeypatch):
    cfg, jcfg = compose(system, SMALL + ["arch.total_num_envs=6",
                                         f"system.num_simulations={SIMULATIONS}",
                                         f"system.num_sampled_actions={K}"])
    module, index = JAX_MODULES[system]
    jsetup, update_step = jax_learner(module, "get_learner_fn", index, jcfg, monkeypatch)
    env_step = inspect.getclosurevars(update_step).nonlocals["_env_step"]
    state = one_replica_state(jsetup)
    _, want = jax.jit(env_step)(state, None)

    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    if system == "ff_sampled_az":
        actor, critic, params = port_actor_critic(env, cfg, state.params)
        acting = ff_sampled_az.SampledAZActing(
            env, ff_az.make_simulator(cfg),
            (ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic)), cfg)
    else:
        nets, params = mz_networks(env, cfg, state.params, True)
        acting = ff_sampled_mz.SampledMZActing(nets, env, cfg)
    noise = sampled_draws(state.key, 6, 1, acting.root_noise)
    obs = Observation(*(t(getattr(state.timestep.observation, k)) for k in Observation._fields))
    action, extras = acting.act(params, noise, port_core(jax_core(state.env_state),
                                                         torch.Generator()), obs)
    np.testing.assert_allclose(n(extras["sampled_actions"]), np.asarray(want["sampled_actions"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n(extras["search_policy"]), np.asarray(want["search_policy"]))
    # ff_sampled_mz's values are the 601-atom codec's decodes, an expectation
    # over atoms of +-300 read through the inverse transform: an ulp of the
    # softmax moves them by about 1e-5 (jax.jit's and eager JAX's own decodes
    # of random logits differ by up to 2e-2).
    np.testing.assert_allclose(n(extras["search_value"]), np.asarray(want["search_value"]),
                               rtol=1e-5, atol=1e-5 if system == "ff_sampled_az" else 2e-4)
    want_action = want["action"] if system == "ff_sampled_mz" else None
    if want_action is not None:
        np.testing.assert_allclose(n(action), np.asarray(want_action), rtol=1e-5, atol=1e-5)
