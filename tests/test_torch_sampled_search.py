"""Sampled AlphaZero and Sampled MuZero of the PyTorch port
(stoix_tpu_torch/systems/search/ff_sampled_az.py and ff_sampled_mz.py)
against the JAX package's, on the CPU, at small widths (MLPs of 16 x 16, a
world model of 16 with 601 atoms), on Pendulum.

1. (One searched env step of each, fed the JAX package's draws, is in
   tests/test_torch_sampled_env_step.py.)
2. Two epochs at `update_batch_size` 1 and 2 against the JAX package's own
   `_update_epoch` on the same sequences (truncations and terminations):
   losses 1e-5 relative, params 1e-5 absolute; one B1 GAE call an epoch on
   ff_sampled_az (batch-major [L - 1, U.B]), none on ff_sampled_mz.
3. C20's refusals (the sweep's runs are in tests/test_torch_search_sweep.py).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.systems.search import ff_sampled_az as jax_sampled_az
from stoix_tpu.systems.search import ff_sampled_mz as jax_sampled_mz
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ActorCriticOptStates
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.networks.heads import NormalAffineTanhDistributionHead
from stoix_tpu_torch.networks.torso import MLPTorso
from stoix_tpu_torch.search import mcts
from stoix_tpu_torch.systems.ddpg.ff_ddpg import action_bounds
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.search import ff_mz, ff_sampled_az, ff_sampled_mz
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from stoix_tpu_torch.utils.training import ClipAdam, make_learning_rate
from test_torch_az import jax_learner, port_actor_critic, replica
from test_torch_continuous import _count_b1_calls
from torch_parity import n, t, to_flax_params

ROOTS = {"ff_sampled_az": "default/anakin/default_ff_sampled_az.yaml",
         "ff_sampled_mz": "default/anakin/default_ff_sampled_mz.yaml"}
MODULES = {"ff_sampled_az": ff_sampled_az, "ff_sampled_mz": ff_sampled_mz}
JAX_MODULES = {"ff_sampled_az": (jax_sampled_az, 4), "ff_sampled_mz": (jax_sampled_mz, 3)}
SMALL = ["network.actor_network.pre_torso.layer_sizes=[16,16]",
         "network.critic_network.pre_torso.layer_sizes=[16,16]", "system.wm_hidden_size=16"]
SWEEP = ["arch.total_num_envs=16", "arch.total_timesteps=2048", "arch.num_evaluation=1",
         "arch.num_eval_episodes=8", "arch.absolute_metric=False", "system.rollout_length=8",
         "logger.use_console=False", "system.multistep_impl=pallas",
         "system.num_simulations=8", "system.num_sampled_actions=4"]
K, SIMULATIONS = 4, 12


def compose(system, overrides):
    cfg = check_total_timesteps(config_lib.compose(config_lib.default_config_dir(),
                                                   ROOTS[system], overrides), 1)
    return cfg, jax_config.compose(jax_config.default_config_dir(), ROOTS[system], overrides)


def sampled_draws(key, batch, action_dim, root_noise):
    """The draws of the JAX sampled `_env_step` from its key."""
    key, sample_key, search_key = jax.random.split(key, 3)
    normals = jax.vmap(lambda k, shape=(batch, action_dim): jax.random.normal(k, shape))
    samples = normals(jax.random.split(sample_key, K))
    blend = None
    if root_noise > 0.0:
        _, noise_key = jax.random.split(key)
        blend = t(jax.random.uniform(noise_key, (batch, K, action_dim)))
    noise_key, element_key, action_key = jax.random.split(search_key, 3)

    def simulation(rng, _):  # each simulation's key split into K draws of [A]
        rng, step_rng = jax.random.split(rng)
        keys = jax.random.split(step_rng, K)
        return rng, jax.vmap(lambda k: jax.random.normal(k, (action_dim,)))(keys)

    def element(rng):  # [S, K, A]
        return jax.lax.scan(simulation, rng, None, length=SIMULATIONS)[1]

    recurrent = jax.jit(jax.vmap(element, out_axes=1))(jax.random.split(element_key, batch))
    search = mcts.SearchNoise(
        t(jax.random.dirichlet(noise_key, jnp.full((K,), 0.3), shape=(batch,))),
        t(jax.random.gumbel(action_key, (batch, K))), t(recurrent))
    return ff_sampled_az.SampledNoise(t(samples), blend, search)


def mz_networks(env, cfg, jparams, continuous):
    """The port's MuZero networks carrying the JAX package's params."""
    num_actions = env.num_actions
    hidden = int(cfg.system.wm_hidden_size)
    if continuous:
        lo, hi = action_bounds(env)
        nets = ff_mz.build_networks(
            env, cfg, torch.Generator(), MLPTorso(num_actions, (hidden // 2,)),
            lambda width: NormalAffineTanhDistributionHead(num_actions, width, lo, hi))
    else:
        from stoix_tpu_torch.networks.heads import CategoricalHead
        from stoix_tpu_torch.networks.model_based import ActionOneHot

        nets = ff_mz.build_networks(env, cfg, torch.Generator(), ActionOneHot(num_actions),
                                    lambda width: CategoricalHead(num_actions, width))
    for module, part in zip(nets.modules, jparams):
        load_flax_params(module, part)
    return nets, ff_mz.MZParams(*(ff_mz.module_params(m) for m in nets.modules))


def one_replica_state(jsetup):
    state = jsetup.learner_state
    return state._replace(params=replica(state.params), opt_states=replica(state.opt_states),
                          buffer_state=None, key=jnp.asarray(np.asarray(state.key)[0, 0]),
                          env_state=jax.tree.map(lambda x: x[0], state.env_state),
                          timestep=jax.tree.map(lambda x: x[0], state.timestep))


def sequences(seed, system, batch, seq_len, obs_dim, action_dim):
    rng = np.random.default_rng(seed)
    lead = (batch, seq_len)
    weights = rng.random(lead + (K,)).astype(np.float32)
    done = (rng.random(lead) < 0.1).astype(np.float32)
    seq = {
        "sampled_actions": rng.uniform(-1.9, 1.9, lead + (K, action_dim)).astype(np.float32),
        "search_policy": weights / weights.sum(-1, keepdims=True),
        "search_value": rng.normal(-3, 2, lead).astype(np.float32),
        "bootstrap_value": rng.normal(-3, 2, lead).astype(np.float32),
        "reward": rng.normal(-2, 1, lead).astype(np.float32),
        "truncated": ((rng.random(lead) < 0.15) & (done == 0)).astype(np.float32),
    }
    view = rng.normal(size=lead + (obs_dim,)).astype(np.float32)
    if system == "ff_sampled_az":
        seq["obs"] = {"agent_view": view, "action_mask": np.ones(lead + (1,), np.float32),
                      "step_count": np.zeros(lead, np.int32)}
        seq["discount"] = 1.0 - done
    else:
        seq.update(obs=view, done=done,
                   action=rng.uniform(-1.9, 1.9, lead + (action_dim,)).astype(np.float32))
    return seq


def as_jax(seq):
    if isinstance(seq["obs"], dict):
        return {**seq, "obs": JaxObservation(*(seq["obs"][k] for k in JaxObservation._fields))}
    return seq


def as_port(seq):
    out = {k: t(v) for k, v in seq.items() if k != "obs"}
    obs = seq["obs"]
    out["obs"] = (Observation(*(t(obs[k]) for k in Observation._fields))
                  if isinstance(obs, dict) else t(obs))
    return out


@pytest.mark.parametrize("update_batch", [1, 2])
@pytest.mark.parametrize("system", list(ROOTS))
def test_epochs_match_jax_update_epoch(system, update_batch, monkeypatch):
    overrides = SMALL + [f"arch.update_batch_size={update_batch}", "arch.total_num_envs=8",
                         "system.multistep_impl=pallas", f"system.num_sampled_actions={K}",
                         "system.total_buffer_size=1024", "system.total_batch_size=12"]
    cfg, jcfg = compose(system, overrides)
    module, index = JAX_MODULES[system]
    jsetup, update_step = jax_learner(module, "get_learner_fn", index, jcfg, monkeypatch)
    jparams, jopts = replica(jsetup.learner_state.params), replica(jsetup.learner_state.opt_states)
    seq_len = int(cfg.system.sample_sequence_length)
    seqs = [sequences(40 + u, system, 6, seq_len, 3, 1) for u in range(update_batch)]
    want = jax_epochs_of(update_step, jparams, jopts, seqs)

    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    epochs, clip = int(cfg.system.epochs), float(cfg.system.max_grad_norm)
    if system == "ff_sampled_az":
        actor, critic, params = port_actor_critic(env, cfg, jparams)
        optims = tuple(ClipAdam(make_learning_rate(float(cfg.system[k]), cfg, epochs), clip,
                                eps=1e-5) for k in ("actor_lr", "critic_lr"))
        update = ff_sampled_az.SampledAZUpdate(
            (ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic)), optims, cfg)
        opt = ActorCriticOptStates(optims[0].init(params.actor_params),
                                   optims[1].init(params.critic_params))
        sides = (("actor_params", jparams.actor_params), ("critic_params", jparams.critic_params))
        keys = ("actor_loss", "entropy", "value_loss")
    else:
        nets, params = mz_networks(env, cfg, jparams, True)
        optim = ClipAdam(float(cfg.system.lr), clip, eps=1e-5)
        update = ff_sampled_mz.SampledMZUpdate(nets, optim, cfg)
        opt = ff_mz.MZOptStates(optim.init(ff_mz.flat_params(params)))
        sides = tuple((f, getattr(jparams, f)) for f in ff_mz.MZParams._fields)
        keys = ("policy_loss", "value_loss", "reward_loss", "entropy")
    params, opts = [params] * update_batch, [opt] * update_batch
    batches = [as_port(s) for s in seqs]
    calls = _count_b1_calls(monkeypatch)
    for wparams, wmetrics in want:
        params, opts, metrics = update(params, opts, batches)
        for key in keys:
            np.testing.assert_allclose(n(metrics[key]).reshape(update_batch), wmetrics[key][0],
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        for u in range(update_batch):
            for side, like in sides:
                for g, w in zip(jax.tree.leaves(to_flax_params(getattr(params[u], side), like)),
                                jax.tree.leaves(getattr(wparams, side))):
                    np.testing.assert_allclose(g, np.asarray(w)[0, u], rtol=0, atol=1e-5)
    assert calls == {"gae": 2 if system == "ff_sampled_az" else 0, "generic": 0}


def jax_epochs_of(update_step, jparams, jopts, seqs):
    update_epoch = inspect.getclosurevars(update_step).nonlocals["_update_epoch"]
    u = len(seqs)
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs)[None], *trees)  # noqa: E731
    carry = (stack([jparams] * u), stack([jopts] * u), stack([as_jax(s) for s in seqs]),
             jax.random.split(jax.random.PRNGKey(11), u)[None])
    fn = jax.jit(jax.vmap(jax.vmap(update_epoch, axis_name="batch"), axis_name="data"))
    out = []
    for _ in range(2):
        carry, metrics = fn(carry, None)
        out.append((carry[0], jax.tree.map(np.asarray, metrics)))
    return out


@pytest.mark.parametrize("system,extra", [("ff_sampled_az", "system.update_guard=halt"),
                                          ("ff_sampled_mz", "system.update_guard=skip"),
                                          ("ff_sampled_mz", "system.unroll_steps=2")])
def test_knobs_the_reference_ignores_are_refused_naming_the_key(system, extra):
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS[system], SWEEP + [extra])
    key = extra.split("=")[0]
    with pytest.raises(NotImplementedError, match=key):
        MODULES[system].run_experiment(cfg, device="cpu")
