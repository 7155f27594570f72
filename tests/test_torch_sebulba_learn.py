"""Sebulba learn steps of the PyTorch port against the JAX package's own.

One learn step of Sebulba ff_ppo, ff_impala and ff_impala_shared_torso on a
fixed numpy [T, E] batch, from identical parameters, against the JAX
package's `get_learn_step`, `get_impala_learn_step` and
`get_shared_impala_learn_step` (jit + shard_map) on 1 and on 2 devices of
the 8-device CPU mesh, the port's learner holding the same count of shards
(two CPU "devices"). ff_ppo is fed the permutations JAX's replicated key
draws. Also with `normalize_observations`, `normalize_rewards` and
`update_guard=skip`. The JAX learners' gradients are the SUM over their
learner devices (their shard_map's `check_vma` transposes the params'
broadcast to a psum; ROADMAP C25), and so are the port's. Tolerances
(float32): losses 1e-5 relative (1e-6 floor: the clip loss is a mean of
O(1) terms that cancel), params 1e-5 absolute, advantages 1e-6 and V-trace
targets 1e-6 of their scale, the statistics 1e-6 relative; one B1 call
each: one GAE call an update, one generic call a minibatch. The
shared-torso network with carried flax params at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from stoix_tpu.base_types import ActorCriticOptStates as JOpt, ActorCriticParams as JParams
from stoix_tpu.base_types import PPOTransition as JTransition
from stoix_tpu.envs.types import Observation as JObservation
from stoix_tpu.ops import running_statistics as jstats
from stoix_tpu.ops.multistep import truncated_generalized_advantage_estimation as jax_gae
from stoix_tpu.ops.multistep import vtrace_td_error_and_advantage as jax_vtrace
from stoix_tpu.systems.impala.sebulba import ff_impala as jimpala
from stoix_tpu.systems.impala.sebulba import ff_impala_shared_torso as jshared
from stoix_tpu.systems.ppo.sebulba import ff_ppo as jppo
from stoix_tpu.utils import config as jax_config
from stoix_tpu.utils.training import make_learning_rate as jax_lr
from stoix_tpu_torch.base_types import ActorCriticParams, PPOTransition
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.ops import running_statistics
from stoix_tpu_torch.systems.anakin import make_generator
from stoix_tpu_torch.systems.impala.sebulba import ff_impala, ff_impala_shared_torso
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import make_apply_fn, make_optimizers
from stoix_tpu_torch.systems.ppo.sebulba import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from test_torch_continuous import _count_b1_calls
from torch_parity import n, paired_networks, t, to_flax_params

T, E, OBS, ACTIONS = 8, 16, 5, 3
CPU = torch.device("cpu")


def configs(system, overrides):
    root = f"default/sebulba/default_{system}.yaml"
    overrides = ["arch.num_updates=10", "system.multistep_impl=pallas", *overrides]
    return (config_lib.compose(config_lib.default_config_dir(), root, overrides),
            jax_config.compose(jax_config.default_config_dir(), root, overrides))


def batch(seed, reward_scale=1.0):
    rng = np.random.default_rng(seed)

    def obs():
        return (rng.normal(size=(T, E, OBS)).astype(np.float32) * 3.0 + 1.0,
                np.ones((T, E, ACTIONS), np.float32), np.zeros((T, E), np.int32))

    done = rng.uniform(size=(T, E)) < 0.1
    return {"obs": obs(), "next_obs": obs(),
            "action": rng.integers(0, ACTIONS, size=(T, E)).astype(np.int32),
            "value": rng.normal(size=(T, E)).astype(np.float32),
            "reward": (rng.normal(size=(T, E)) * reward_scale + 0.5).astype(np.float32),
            "log_prob": np.log(rng.uniform(0.2, 0.8, size=(T, E))).astype(np.float32),
            "done": done, "truncated": (rng.uniform(size=(T, E)) < 0.1) & ~done}


def jax_batch(b):
    return JTransition(
        done=jnp.asarray(b["done"]), truncated=jnp.asarray(b["truncated"]),
        action=jnp.asarray(b["action"]), value=jnp.asarray(b["value"]),
        reward=jnp.asarray(b["reward"]), log_prob=jnp.asarray(b["log_prob"]),
        obs=JObservation(*map(jnp.asarray, b["obs"])),
        next_obs=JObservation(*map(jnp.asarray, b["next_obs"])), info={})


def port_shards(b, shards):
    def cut(x, i):
        return t(np.split(np.asarray(x), shards, axis=1)[i])

    def obs(o, i):
        return Observation(*(cut(x, i) for x in o))

    return [PPOTransition(done=cut(b["done"], i), truncated=cut(b["truncated"], i),
                          action=cut(b["action"], i).long(), value=cut(b["value"], i),
                          reward=cut(b["reward"], i), log_prob=cut(b["log_prob"], i),
                          obs=obs(b["obs"], i), next_obs=obs(b["next_obs"], i), info={})
            for i in range(shards)]


def jax_optims(jcfg):
    s = jcfg.system

    def optim(lr):
        return optax.chain(optax.clip_by_global_norm(float(s.max_grad_norm)),
                           optax.adam(jax_lr(float(lr), jcfg, int(s.epochs),
                                             int(s.num_minibatches)), eps=1e-5))

    return optim(s.actor_lr), optim(s.critic_lr)


def port_state(actor, critic, cfg):
    params = ActorCriticParams({k: v.detach() for k, v in actor.named_parameters()},
                               {k: v.detach() for k, v in critic.named_parameters()})
    optims = make_optimizers(cfg)
    from stoix_tpu_torch.base_types import ActorCriticOptStates

    opt = ActorCriticOptStates(optims[0].init(params.actor_params),
                               optims[1].init(params.critic_params))
    stats = running_statistics.init_state(torch.zeros(OBS))
    return ff_ppo.CoreLearnerState(params, opt, make_generator(0, CPU), stats), optims


def jax_state(jap, jcp, jcfg, key):
    actor_optim, critic_optim = jax_optims(jcfg)
    state = jppo.CoreLearnerState(JParams(jap, jcp),
                                  JOpt(actor_optim.init(jap), critic_optim.init(jcp)), key,
                                  jstats.init_state(jnp.zeros((OBS,), jnp.float32)))
    return state, (actor_optim.update, critic_optim.update)


def assert_params(port_params, jax_params, atol=1e-5):
    for side in (0, 1):
        got = to_flax_params(port_params[side], jax_params[side])
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax_params[side])):
            np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


def assert_metrics(port, jax_metrics, keys):
    for k in keys:
        np.testing.assert_allclose(n(port[k]), np.asarray(jax_metrics[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def assert_stats(port, jax_stats):
    for name in ("mean", "std", "summed_variance"):
        want = np.asarray(getattr(jax_stats, name))
        np.testing.assert_allclose(n(getattr(port, name)), want,
                                   atol=1e-6 * float(np.abs(want).max() + 1.0), err_msg=name)
    assert float(port.count) == float(jax_stats.count)


PPO_CASES = {
    "plain": [],
    "knobs": ["system.normalize_observations=true", "system.update_guard=skip"],
}


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("case", list(PPO_CASES))
def test_ppo_learn_step_matches_jax(shards, case, devices, monkeypatch):
    cfg, jcfg = configs("ff_ppo", ["system.epochs=2", "system.num_minibatches=2",
                                   "system.actor_lr=1e-3", "system.critic_lr=1e-3",
                                   *PPO_CASES[case]])
    ja, jap, jc, jcp, ta, tc = paired_networks(OBS, ACTIONS, (16, 16), seed=3)
    b = batch(11)
    key = jax.random.PRNGKey(5)
    jstate, jupdates = jax_state(jap, jcp, jcfg, key)
    mesh = Mesh(np.asarray(devices[:shards]), ("data",))
    step = jppo.get_learn_step(ja.apply, jc.apply, jupdates, jcfg, mesh)
    jnew, jmetrics = step(jstate, jax_batch(b))

    # The permutations JAX's replicated key draws, one per epoch.
    permutations, k = [], key
    for _ in range(int(cfg.system.epochs)):
        k, sub = jax.random.split(k)
        permutations.append(torch.from_numpy(np.asarray(
            jax.random.permutation(sub, T * E // shards)).astype(np.int64)))
    state, optims = port_state(ta, tc, cfg)
    learn = ff_ppo.get_learn_step(make_apply_fn(ta), make_apply_fn(tc), optims, cfg,
                                  [CPU] * shards)
    calls = _count_b1_calls(monkeypatch)
    new, metrics = learn(state, port_shards(b, shards), permutations=permutations)
    assert calls == {"gae": 1, "generic": 0}

    keys = ["actor_loss", "value_loss", "entropy"]
    if case == "knobs":
        keys += ["skipped_updates", "guard_loss", "guard_grad_norm"]
        assert_stats(new.obs_stats, jnew.obs_stats)
    assert_metrics(metrics, jmetrics, keys)
    assert_params(new.params, (jnew.params.actor_params, jnew.params.critic_params))


@pytest.mark.parametrize("shards", [1, 2])
def test_ppo_advantages_match_jax_per_shard(shards):
    """GAE in one call over the shards side by side, each shard's advantages
    standardised over the shard alone, as inside the JAX shard."""
    cfg, jcfg = configs("ff_ppo", ["system.normalize_observations=true"])
    ja, jap, jc, jcp, ta, tc = paired_networks(OBS, ACTIONS, (16, 16), seed=3)
    b = batch(12)
    state, optims = port_state(ta, tc, cfg)
    learn = ff_ppo.get_learn_step(make_apply_fn(ta), make_apply_fn(tc), optims, cfg,
                                  [CPU] * shards)
    _, _, advantages, targets = learn.prepare(state, port_shards(b, shards))
    stats0 = jstats.init_state(jnp.zeros((OBS,), jnp.float32))
    jb = jax_batch(b)
    for i in range(shards):
        cols = slice(i * E // shards, (i + 1) * E // shards)
        part = jax.tree.map(lambda x: x[:, cols], jb)
        next_obs = jstats.normalize_observation(part.next_obs, stats0)
        gae = jax.jit(lambda r, d, v, vt, tr: jax_gae(
            r, d, float(jcfg.system.gae_lambda), v_tm1=v, v_t=vt, truncation_t=tr,
            standardize_advantages=True, impl="scan"))
        adv, tgt = gae(part.reward, 0.99 * (1.0 - part.done.astype(jnp.float32)), part.value,
                       jc.apply(jcp, next_obs), part.truncated.astype(jnp.float32))
        np.testing.assert_allclose(n(advantages[i]), np.asarray(adv), atol=1e-6, rtol=0)
        np.testing.assert_allclose(n(targets[i]), np.asarray(tgt), atol=1e-6, rtol=0)


IMPALA_CASES = {
    "plain": [],
    "knobs": ["system.normalize_observations=true", "system.normalize_rewards=true",
              "system.update_guard=skip"],
}


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("case", list(IMPALA_CASES))
def test_impala_learn_step_matches_jax(shards, case, devices, monkeypatch):
    cfg, jcfg = configs("ff_impala", ["system.num_minibatches=2", *IMPALA_CASES[case]])
    ja, jap, jc, jcp, ta, tc = paired_networks(OBS, ACTIONS, (16, 16), seed=4)
    b = batch(13, reward_scale=3.0)
    jstate, jupdates = jax_state(jap, jcp, jcfg, jax.random.PRNGKey(0))
    mesh = Mesh(np.asarray(devices[:shards]), ("data",))
    step = jimpala.get_impala_learn_step(ja.apply, jc.apply, jupdates, jcfg, mesh)
    jnew, jmetrics = step(jstate, jax_batch(b))

    state, optims = port_state(ta, tc, cfg)
    learn = ff_impala.get_impala_learn_step(make_apply_fn(ta), make_apply_fn(tc), optims, cfg,
                                            [CPU] * shards)
    calls = _count_b1_calls(monkeypatch)
    new, metrics = learn(state, port_shards(b, shards))
    # One generic B1 call a minibatch (V-trace), over the shards at once.
    assert calls == {"gae": 0, "generic": int(cfg.system.num_minibatches)}
    keys = ["actor_loss", "value_loss", "entropy", "mean_rho"]
    if case == "knobs":
        keys += ["skipped_updates", "guard_loss", "guard_grad_norm"]
        assert_stats(new.obs_stats, jnew.obs_stats)
    assert_metrics(metrics, jmetrics, keys)
    assert_params(new.params, (jnew.params.actor_params, jnew.params.critic_params))


@pytest.mark.parametrize("shards", [1, 2])
def test_impala_vtrace_targets_match_jax(shards):
    """The first minibatch's V-trace targets (errors + values) and policy-
    gradient advantages against the JAX package's vmapped V-trace, with the
    whole batch's reward normalisation."""
    cfg, jcfg = configs("ff_impala", ["system.num_minibatches=2",
                                      "system.normalize_rewards=true"])
    ja, jap, jc, jcp, ta, tc = paired_networks(OBS, ACTIONS, (16, 16), seed=4)
    b = batch(14, reward_scale=3.0)
    state, optims = port_state(ta, tc, cfg)
    learn = ff_impala.get_impala_learn_step(make_apply_fn(ta), make_apply_fn(tc), optims, cfg,
                                            [CPU] * shards)
    shards_in, _ = learn.prepare(state, port_shards(b, shards))
    first = [ff_impala.split_env_minibatches(s, 2)[0] for s in shards_in]
    forwards, outs = learn.forward_and_vtrace(state.params, first)

    jb = jax_batch(b)
    r = jb.reward
    r = (r - r.mean()) / (jnp.sqrt(jnp.maximum((r ** 2).mean() - r.mean() ** 2, 0.0)) + 1e-8)
    jb = jb._replace(reward=r)
    for i in range(shards):
        width = E // shards
        cols = slice(i * width, i * width + width // 2)  # the shard's first minibatch
        mb = jax.tree.map(lambda x: x[:, cols], jb)
        online = ja.apply(jap, mb.obs).log_prob(mb.action)
        values, boot = jc.apply(jcp, mb.obs), jc.apply(jcp, mb.next_obs)
        rhos = jnp.exp(online - mb.log_prob)
        errors, pg_adv, _ = jax.jit(jax.vmap(
            lambda v, bt, rr, d, rho: jax_vtrace(v, bt, rr, d, rho, 1.0, 1.0, 1.0, impl="scan"),
            in_axes=1, out_axes=1))(values, boot, mb.reward,
                                    0.99 * (1.0 - mb.done.astype(jnp.float32)), rhos)
        got_errors, got_pg = outs[i]
        values_port = forwards[i][2]
        # 1e-6 of their scale: the values themselves come from the networks.
        np.testing.assert_allclose(n(got_errors + values_port), np.asarray(errors + values),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(n(got_pg), np.asarray(pg_adv), atol=1e-6, rtol=1e-6)


def shared_pair(seed):
    """The JAX package's shared-torso views with their flax params, and the
    port's with the same params."""
    from stoix_tpu_torch.envs import spaces

    cfg, jcfg = configs("ff_impala_shared_torso",
                        ["network.actor_network.pre_torso.layer_sizes=[16,16]",
                         "system.num_minibatches=2"])
    dummy = JObservation(jnp.zeros((1, OBS)), jnp.ones((1, ACTIONS)), jnp.zeros((1,), jnp.int32))
    jactor, jcritic = jshared.build_shared_networks(jcfg, ACTIONS, dummy)
    jparams = jax.tree.map(np.asarray, jactor.init(jax.random.PRNGKey(seed), dummy))

    class Probe:
        num_actions = ACTIONS

        @staticmethod
        def observation_value():
            return Observation(torch.zeros(OBS), torch.ones(ACTIONS),
                               torch.zeros((), dtype=torch.int32))

        @staticmethod
        def action_space():
            return spaces.Discrete(ACTIONS)

    actor, critic = ff_impala_shared_torso.build_shared_networks(cfg, Probe, make_generator(0, CPU))
    load_flax_params(actor, jparams)
    return cfg, jcfg, jactor, jcritic, jparams, actor, critic


def test_shared_torso_network_with_carried_flax_params():
    cfg, jcfg, jactor, jcritic, jparams, actor, critic = shared_pair(2)
    rng = np.random.default_rng(0)
    view = rng.normal(size=(7, OBS)).astype(np.float32)
    jobs = JObservation(jnp.asarray(view), jnp.ones((7, ACTIONS)), jnp.zeros((7,), jnp.int32))
    obs = Observation(t(view), torch.ones((7, ACTIONS)), torch.zeros((7,), dtype=torch.int32))
    # Both views hold the same parameters, under flax's `net` tree.
    assert dict(actor.named_parameters()).keys() == dict(critic.named_parameters()).keys()
    assert all(a is c for a, c in zip(actor.parameters(), critic.parameters()))
    np.testing.assert_allclose(n(actor(obs).logits), np.asarray(jactor.apply(jparams, jobs).logits),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(critic(obs)), np.asarray(jcritic.apply(jparams, jobs)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shards", [1, 2])
def test_shared_torso_learn_step_matches_jax(shards, devices, monkeypatch):
    cfg, jcfg, jactor, jcritic, jparams, actor, critic = shared_pair(6)
    b = batch(15)
    jstate, jupdates = jax_state(jparams, jparams, jcfg, jax.random.PRNGKey(0))
    mesh = Mesh(np.asarray(devices[:shards]), ("data",))
    step = jshared.get_shared_impala_learn_step(jactor.apply, jcritic.apply, jupdates, jcfg, mesh)
    jnew, jmetrics = step(jstate, jax_batch(b))

    state, optims = port_state(actor, critic, cfg)
    learn = ff_impala_shared_torso.get_shared_impala_learn_step(
        make_apply_fn(actor), make_apply_fn(critic), optims, cfg, [CPU] * shards)
    calls = _count_b1_calls(monkeypatch)
    new, metrics = learn(state, port_shards(b, shards))
    assert calls == {"gae": 0, "generic": 2}
    assert_metrics(metrics, jmetrics, ["actor_loss", "value_loss", "entropy", "mean_rho"])
    # Both slots hold the one updated tree.
    assert new.params.actor_params is new.params.critic_params
    got = to_flax_params(new.params.actor_params, jparams)
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(jnew.params.actor_params)):
        np.testing.assert_allclose(a, np.asarray(w), atol=1e-5, rtol=0)
    for a, w in zip(jax.tree.leaves(jnew.params.actor_params),
                    jax.tree.leaves(jnew.params.critic_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))
