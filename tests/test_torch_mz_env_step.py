"""One searched env step of MuZero of the PyTorch port in the learned model
against the JAX package's own `_env_step` (jitted), on the CPU, at a small
width (a world model of 16 with an LSTM, 601 atoms), on IdentityGame with
every env's level pinned, fed its draws (the Dirichlet and the
categorical's Gumbel from the step's key; the Gumbel root's for
`search_method=gumbel`): the actions and the visit weights exactly, the root
values 2e-4 absolute (the 601-atom codec's decodes, an expectation over
atoms of +-300: jax.jit and eager JAX decode random logits up to 2e-2
apart), the Gumbel variant's weights (a softmax over decoded Q values)
1e-4."""

import inspect

import jax
import numpy as np
import pytest

from stoix_tpu.systems.search import ff_mz as jax_mz
from stoix_tpu_torch import envs
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.systems.search import ff_mz
from test_torch_az import az_draws, jax_learner, pin_levels
from test_torch_mz import SMALL, compose
from test_torch_sampled_search import mz_networks, one_replica_state
from torch_parity import n, t


@pytest.mark.parametrize("method", ["muzero", "gumbel"])
def test_one_env_step_fed_jax_draws_matches_the_jax_env_step(method, monkeypatch):
    cfg, jcfg = compose(SMALL + ["arch.total_num_envs=10", "system.num_simulations=12",
                                 f"system.search_method={method}"])
    jsetup, update_step = jax_learner(jax_mz, "get_learner_fn", 3, jcfg, monkeypatch)
    env_step = inspect.getclosurevars(update_step).nonlocals["_env_step"]
    state = one_replica_state(jsetup)
    state = state._replace(env_state=pin_levels(state.env_state))
    _, want = jax.jit(env_step)(state, None)

    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    nets, params = mz_networks(env, cfg, state.params, False)
    acting = ff_mz.MZActing(nets, env.num_actions, cfg)
    noise = az_draws(state.key, 10, env.num_actions, method == "gumbel")
    obs = Observation(*(t(getattr(state.timestep.observation, k)) for k in Observation._fields))
    action, extras = acting.act(params, noise, None, obs)
    np.testing.assert_array_equal(n(action), np.asarray(want["action"]))
    if method == "muzero":  # visit fractions
        np.testing.assert_array_equal(n(extras["search_policy"]),
                                      np.asarray(want["search_policy"]))
    else:  # softmax(logits + sigma(Q)) of decoded Q values
        np.testing.assert_allclose(n(extras["search_policy"]), np.asarray(want["search_policy"]),
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(n(extras["search_value"]), np.asarray(want["search_value"]),
                               rtol=1e-5, atol=2e-4)
