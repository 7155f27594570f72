"""Anakin AlphaZero of the PyTorch port (stoix_tpu_torch/systems/search/
ff_az.py) against the JAX package's, on the CPU, at a small width (MLPs of
16 x 16).

1. One searched env step (the JAX package's own `_env_step`, taken from its
   learner's closure, jitted) fed the JAX package's draws (its Dirichlet and
   the categorical's Gumbel from the step's key; its Gumbel root's for
   `search_method=gumbel`), on CartPole (deterministic dynamics; envs close
   to termination and to the 500-step limit) and on IdentityGame with every
   env's level pinned: the actions, the visit weights exactly, the root
   values 1e-5 relative; then the learner's own env step stores them.
2. One on-policy update step at `update_batch_size` 1 and 2 from explicit
   [T, E] searched trajectories with terminations and truncations, against
   the JAX package's composition (its targets, ff_az.py:181-191, then its
   own `_update_minibatch` over the same permutations) under vmap over
   "batch" and "data": the targets 1e-6 absolute, losses 1e-5 relative,
   params 1e-5 absolute; one GAE call ([T, U.E]) and no generic one.
3. Two replay epochs (`use_replay_buffer=true`) at U = 1 and 2 against the
   JAX package's own `_update_epoch` on the same sequences: one GAE call an
   epoch over [L - 1, U.B] from the batch-major view.
4. The replay rollout's stores, a resume bitwise the unbroken run, C20's
   refusals (the sweep's runs and the IdentityGame oracle are in
   tests/test_torch_search_sweep.py).
"""

import inspect
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu import envs as jax_envs
from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.parallel.mesh import create_mesh
from stoix_tpu.systems.search import ff_az as jax_az
from stoix_tpu.utils import config as jax_config
from stoix_tpu.utils.jax_utils import tree_merge_leading_dims as jax_merge
from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams
from stoix_tpu_torch.envs.classic import PhysicsState
from stoix_tpu_torch.envs.debug import IdentityState
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.search import mcts
from stoix_tpu_torch.systems import anakin, runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.search import ff_az
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from stoix_tpu_torch.utils.tree import tree_stack
from test_torch_continuous import _count_b1_calls
from torch_parity import n, t, to_flax_params

ROOT = "default/anakin/default_ff_az.yaml"
SMALL = ["network.actor_network.pre_torso.layer_sizes=[16,16]",
         "network.critic_network.pre_torso.layer_sizes=[16,16]"]
SWEEP = ["arch.total_num_envs=16", "arch.total_timesteps=2048", "arch.num_evaluation=1",
         "arch.num_eval_episodes=8", "arch.absolute_metric=False", "system.rollout_length=8",
         "logger.use_console=False", "system.multistep_impl=pallas", "env=identity_game",
         "system.num_simulations=8"]
REPLAY = ["system.use_replay_buffer=true", "system.total_buffer_size=4096",
          "system.total_batch_size=32"]


def compose(overrides):
    cfg = check_total_timesteps(config_lib.compose(config_lib.default_config_dir(), ROOT,
                                                   overrides), 1)
    return cfg, jax_config.compose(jax_config.default_config_dir(), ROOT, overrides)


def jax_learner(module, fn_name, buffer_index, jcfg, monkeypatch, seed=3):
    """The JAX package's learner setup on a one-device mesh, and its
    `_update_step` rebuilt by `fn_name` from the same arguments (with a
    buffer whose sample hands back its state, at `buffer_index`)."""
    captured = {}
    original = getattr(module, fn_name)

    def capture(*args):
        captured["args"] = list(args)
        return original(*args)

    monkeypatch.setattr(module, fn_name, capture)
    env, _ = jax_envs.make(jcfg)
    mesh = create_mesh({"data": 1}, jax.devices()[:1])
    setup = module.learner_setup(env, jcfg, mesh, jax.random.PRNGKey(seed))
    args = captured["args"]
    if buffer_index is not None:
        args[buffer_index] = SimpleNamespace(
            sample=lambda state, key: SimpleNamespace(experience=state))
    learn = original(*args)
    return setup, inspect.getclosurevars(learn).nonlocals["_update_step"]


def replica(tree, u=0):
    return jax.tree.map(lambda x: np.asarray(x)[u], tree)


def port_actor_critic(env, cfg, jparams):
    actor, critic = ff_ppo.build_networks(env, cfg, torch.Generator())
    load_flax_params(actor, jparams.actor_params)
    load_flax_params(critic, jparams.critic_params)
    params = ActorCriticParams({k: v.detach() for k, v in actor.named_parameters()},
                               {k: v.detach() for k, v in critic.named_parameters()})
    return actor, critic, params


def jax_core(state):
    while hasattr(state, "inner"):
        state = state.inner
    return state


def pin_levels(state):
    """The JAX IdentityGame state with every env's level pinned to its target."""
    if hasattr(state, "inner"):
        return state._replace(inner=pin_levels(state.inner))
    return state._replace(level=state.target)


def port_core(core, generator):
    """The port's core env state of a JAX core state (its key left out)."""
    if hasattr(core, "physics"):
        return PhysicsState(generator, t(core.physics), t(core.step_count))
    return IdentityState(generator, t(core.target).long(), t(core.step_count),
                         t(core.level).long())


def port_observation(obs):
    return Observation(*(t(getattr(obs, k)) for k in Observation._fields))


def az_draws(key, batch, num_actions, gumbel):
    """The draws of the JAX `_env_step`'s search from its key."""
    _, search_key = jax.random.split(key)
    if gumbel:
        gumbel_key, _ = jax.random.split(search_key)
        return mcts.SearchNoise(None, t(jax.random.gumbel(gumbel_key, (batch, num_actions))))
    noise_key, _, action_key = jax.random.split(search_key, 3)
    return mcts.SearchNoise(
        t(jax.random.dirichlet(noise_key, jnp.full((num_actions,), 0.3), shape=(batch,))),
        t(jax.random.gumbel(action_key, (batch, num_actions))))


def cartpole_near_limits(jax_state, seed):
    """The JAX CartPole envs moved near the pole's angle limit (some) and
    the 500-step limit (others), so the search meets terminations and
    truncations."""
    core = jax_core(jax_state)
    rng = np.random.default_rng(seed)
    physics = np.asarray(core.physics).copy()
    e = physics.shape[0]
    physics[: e // 3, 2] = rng.uniform(0.15, 0.2, e // 3) * rng.choice([-1, 1], e // 3)
    steps = np.asarray(core.step_count).copy()
    near = slice(e // 3, 2 * e // 3)
    steps[near] = rng.integers(490, 499, len(steps[near]))
    new = core._replace(physics=jnp.asarray(physics), step_count=jnp.asarray(steps))

    def put(state):
        return state._replace(inner=put(state.inner)) if hasattr(state, "inner") else new

    return put(jax_state)


@pytest.mark.parametrize("env_name,method", [("cartpole", "muzero"), ("cartpole", "gumbel"),
                                             ("identity_game", "muzero")])
def test_one_env_step_fed_jax_draws_matches_the_jax_env_step(env_name, method, monkeypatch):
    overrides = SMALL + [f"env={env_name}", "arch.total_num_envs=12",
                         f"system.search_method={method}", "system.num_simulations=16"]
    cfg, jcfg = compose(overrides)
    jsetup, update_step = jax_learner(jax_az, "get_learner_fn", None, jcfg, monkeypatch)
    env_step = inspect.getclosurevars(update_step).nonlocals["_env_step"]
    state = jsetup.learner_state
    state = state._replace(params=replica(state.params), opt_states=replica(state.opt_states),
                           key=jnp.asarray(np.asarray(state.key)[0, 0]),
                           env_state=jax.tree.map(lambda x: x[0], state.env_state),
                           timestep=jax.tree.map(lambda x: x[0], state.timestep))
    if env_name == "identity_game":
        state = state._replace(env_state=pin_levels(state.env_state))
    else:
        state = state._replace(env_state=cartpole_near_limits(state.env_state, 1))
        obs = state.timestep.observation
        state = state._replace(timestep=state.timestep._replace(observation=obs._replace(
            agent_view=jax_core(state.env_state).physics)))
    _, want = jax.jit(env_step)(state, None)

    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    actor, critic, params = port_actor_critic(env, cfg, state.params)
    search = ff_az.AZSearch(ff_az.make_simulator(cfg),
                            (ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic)), cfg)
    batch = int(cfg.arch.total_num_envs)
    noise = az_draws(state.key, batch, env.num_actions, method == "gumbel")
    sim_state = port_core(jax_core(state.env_state), torch.Generator())
    value, out = search(params, noise, sim_state, port_observation(state.timestep.observation))
    np.testing.assert_array_equal(n(out.action), np.asarray(want.action))
    np.testing.assert_array_equal(n(out.action_weights), np.asarray(want.search_policy))
    np.testing.assert_allclose(n(out.search_value), np.asarray(want.search_value), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(n(value), np.asarray(want.value), rtol=1e-5, atol=1e-6)
    # The simulator's steps leave the root state's tensors as they were.
    np.testing.assert_array_equal(n(sim_state.step_count),
                                  np.asarray(jax_core(state.env_state).step_count))


def test_learner_env_step_stores_the_search_and_steps_the_envs():
    """Fed noise, the step is the search on the envs' core states with the
    replica's generator in place of the env's: the simulator's IdentityGame
    draws its targets from the step generator (C21), and the env draws its
    next targets from its own."""
    cfg, _ = compose(SMALL + SWEEP)
    setup = ff_az.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 5)
    learner, state = setup.learn, setup.learner_state
    noise = learner.search.draw_noise(torch.Generator().manual_seed(0), 16)
    core = ff_az.unwrap_env_state(state.env_state)
    targets = core.target.clone()

    def copy(generator):
        return torch.Generator().set_state(generator.get_state())

    step_copy, env_copy = copy(state.generator), copy(core.generator)
    new_state, transition = learner.env_step(state, [noise])
    sim_state = ff_az.simulator_state(state.env_state, 0, 1, step_copy)
    value, out = learner.search(state.params, noise, sim_state, state.timestep.observation)
    assert torch.equal(transition.action, out.action)
    assert torch.equal(transition.search_policy, out.action_weights)
    assert torch.equal(transition.search_value, out.search_value)
    assert torch.equal(transition.value, value)
    assert torch.equal(transition.reward, (out.action == targets).to(torch.float32))
    assert torch.equal(state.generator.get_state(), step_copy.get_state())
    assert torch.equal(ff_az.unwrap_env_state(new_state.env_state).target,
                       torch.randint(0, 4, (16,), generator=env_copy))


def trajectory(seed, t_len, n_envs, obs_dim, num_actions):
    rng = np.random.default_rng(seed)

    def obs():
        return {"agent_view": rng.normal(size=(t_len, n_envs, obs_dim)).astype(np.float32),
                "action_mask": np.ones((t_len, n_envs, num_actions), np.float32),
                "step_count": np.zeros((t_len, n_envs), np.int32)}

    weights = rng.random((t_len, n_envs, num_actions)).astype(np.float32)
    done = rng.random((t_len, n_envs)) < 0.1
    return {
        "done": done, "truncated": (rng.random((t_len, n_envs)) < 0.1) & ~done,
        "action": rng.integers(0, num_actions, (t_len, n_envs)).astype(np.int32),
        "value": rng.normal(size=(t_len, n_envs)).astype(np.float32),
        "reward": rng.normal(size=(t_len, n_envs)).astype(np.float32),
        "search_policy": weights / weights.sum(-1, keepdims=True),
        "search_value": rng.normal(size=(t_len, n_envs)).astype(np.float32),
        "obs": obs(), "next_obs": obs(), "info": {},
    }


def jax_transition(traj):
    as_obs = lambda o: JaxObservation(*(o[k] for k in JaxObservation._fields))  # noqa: E731
    return jax_az.ExItTransition(**{**traj, "obs": as_obs(traj["obs"]),
                                    "next_obs": as_obs(traj["next_obs"])})


def port_transition(traj):
    as_obs = lambda o: Observation(*(t(o[k]) for k in Observation._fields))  # noqa: E731
    return ff_az.ExItTransition(**{k: t(v) for k, v in traj.items()
                                   if k not in ("obs", "next_obs", "info")},
                                obs=as_obs(traj["obs"]), next_obs=as_obs(traj["next_obs"]),
                                info={})


def jax_update_fn(update_step, jcfg):
    """ff_az.py:174-211 after the rollout, one replica's: the targets, then
    `epochs` x `num_minibatches` of the package's own `_update_minibatch`
    (its gradients pmeaned over "batch" then "data") over the given
    permutations [epochs, T.E]: (params, targets, loss info)."""
    from stoix_tpu.ops import truncated_generalized_advantage_estimation as jax_gae

    closure = inspect.getclosurevars(update_step).nonlocals
    update_minibatch, critic_apply = closure["_update_minibatch"], closure["critic_apply"]
    gamma, lam = float(jcfg.system.gamma), float(jcfg.system.gae_lambda)

    def step(params, opt_states, traj, perm):
        v_t_net = critic_apply(params.critic_params, traj.next_obs)
        sv_next = jnp.concatenate([traj.search_value[1:], v_t_net[-1:]], axis=0)
        v_t = jnp.where(traj.truncated.astype(bool), v_t_net, sv_next)
        _, targets = jax_gae(traj.reward, gamma * (1.0 - traj.done.astype(jnp.float32)), lam,
                             v_tm1=traj.search_value, v_t=v_t,
                             truncation_t=traj.truncated.astype(jnp.float32))
        infos = []
        for epoch in range(int(jcfg.system.epochs)):
            flat = jax_merge((traj.obs, traj.search_policy, targets), 2)
            shuffled = jax.tree.map(lambda x: jnp.take(x, perm[epoch], axis=0), flat)
            minibatches = jax.tree.map(lambda x: x.reshape(
                (int(jcfg.system.num_minibatches), -1) + x.shape[1:]), shuffled)
            (params, opt_states), info = jax.lax.scan(update_minibatch, (params, opt_states),
                                                      minibatches)
            infos.append(info)
        return params, targets, jax.tree.map(lambda *xs: jnp.stack(xs), *infos)

    return step


def jax_update(update_step, jcfg, params, opt_states, trajs, perms):
    """`jax_update_fn`'s step under vmap over "batch" (the replicas) and
    "data" (one shard)."""
    step = jax_update_fn(update_step, jcfg)
    fn = jax.jit(jax.vmap(jax.vmap(step, axis_name="batch"), axis_name="data"))
    u = len(trajs)
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs)[None], *trees)  # noqa: E731
    return fn(stack([params] * u), stack([opt_states] * u), stack(trajs), stack(perms))


@pytest.mark.parametrize("update_batch", [1, 2])
def test_one_update_step_matches_jax_composition(update_batch, monkeypatch):
    overrides = SMALL + [f"arch.update_batch_size={update_batch}", "system.multistep_impl=pallas",
                         "system.ent_coef=0.05", "system.actor_lr=1e-3", "system.critic_lr=1e-3",
                         "env=identity_game", "arch.total_num_envs=8"]
    cfg, jcfg = compose(overrides)
    jsetup, update_step = jax_learner(jax_az, "get_learner_fn", None, jcfg, monkeypatch)
    jparams, jopts = replica(jsetup.learner_state.params), replica(jsetup.learner_state.opt_states)
    t_len, n_envs = 6, 8
    trajs = [trajectory(10 + u, t_len, n_envs, 4, 4) for u in range(update_batch)]
    rng = np.random.default_rng(2)
    perms = [np.stack([rng.permutation(t_len * n_envs) for _ in range(int(cfg.system.epochs))])
             for _ in range(update_batch)]
    want_params, want_targets, want_info = jax_update(
        update_step, jcfg, jparams, jopts, [jax_transition(tr) for tr in trajs], perms)

    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    actor, critic, params = port_actor_critic(env, cfg, jparams)
    optims = ff_ppo.make_optimizers(cfg)
    learner = ff_az.AZLearner(None, None, (ff_ppo.make_apply_fn(actor),
                                           ff_ppo.make_apply_fn(critic)), optims, cfg)
    opt = ActorCriticOptStates(optims[0].init(params.actor_params),
                               optims[1].init(params.critic_params))
    params, opt = anakin.broadcast_to_update_batch(params, update_batch), \
        anakin.broadcast_to_update_batch(opt, update_batch)
    traj = tree_stack([port_transition(tr) for tr in trajs])  # [U, T, E]
    traj = traj._replace(**{f: getattr(traj, f).transpose(0, 1).reshape(
        (t_len, update_batch * n_envs) + getattr(traj, f).shape[3:])
        for f in ("done", "truncated", "action", "value", "reward", "search_policy",
                  "search_value")})
    as_time_major = lambda o: Observation(*(x.transpose(0, 1).reshape(  # noqa: E731
        (t_len, update_batch * n_envs) + x.shape[3:]) for x in o))
    traj = traj._replace(obs=as_time_major(traj.obs), next_obs=as_time_major(traj.next_obs))
    permutations = [torch.from_numpy(np.stack([p[e] for p in perms]))
                    if update_batch > 1 else torch.from_numpy(perms[0][e])
                    for e in range(int(cfg.system.epochs))]
    calls = _count_b1_calls(monkeypatch)
    targets = learner.targets(anakin.split_replicas(params, update_batch), traj)
    assert calls == {"gae": 1, "generic": 0}
    got_targets = n(targets).reshape(t_len, update_batch, n_envs).transpose(1, 0, 2)
    np.testing.assert_allclose(got_targets, np.asarray(want_targets)[0], rtol=0, atol=1e-6)
    new_params, _, info = learner.update(params, opt, traj, permutations=permutations)
    assert calls == {"gae": 2, "generic": 0}
    for key in ("actor_loss", "value_loss", "entropy"):
        got = n(info[key])  # [epochs, minibatches], and [U] last past one replica
        got = got[None] if update_batch == 1 else np.moveaxis(got, -1, 0)
        np.testing.assert_allclose(got, np.asarray(want_info[key])[0], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    for u, p in enumerate(anakin.split_replicas(new_params, update_batch)):
        for side in ("actor_params", "critic_params"):
            like = getattr(jparams, side)
            for g, w in zip(jax.tree.leaves(to_flax_params(getattr(p, side), like)),
                            jax.tree.leaves(getattr(want_params, side))):
                np.testing.assert_allclose(g, np.asarray(w)[0, u], rtol=0, atol=1e-5)


def sequences(seed, batch, seq_len, num_actions, obs_dim=4):
    rng = np.random.default_rng(seed)
    lead = (batch, seq_len)
    weights = rng.random(lead + (num_actions,)).astype(np.float32)
    discount = (rng.random(lead) > 0.15).astype(np.float32)
    return {
        "obs": {"agent_view": rng.normal(size=lead + (obs_dim,)).astype(np.float32),
                "action_mask": np.ones(lead + (num_actions,), np.float32),
                "step_count": np.zeros(lead, np.int32)},
        "search_policy": weights / weights.sum(-1, keepdims=True),
        "search_value": rng.normal(size=lead).astype(np.float32),
        "bootstrap_value": rng.normal(size=lead).astype(np.float32),
        "reward": rng.normal(size=lead).astype(np.float32),
        "discount": discount,
        "truncated": ((rng.random(lead) < 0.15) & (discount > 0)).astype(np.float32),
    }


def jax_sequences(seq):
    return {**seq, "obs": JaxObservation(*(seq["obs"][k] for k in JaxObservation._fields))}


def port_sequences(seq):
    return {**{k: t(v) for k, v in seq.items() if k != "obs"},
            "obs": Observation(*(t(seq["obs"][k]) for k in Observation._fields))}


def jax_epochs(update_step, jparams, jopt, seqs, epochs, seed=11):
    """The JAX package's own `_update_epoch` on the given sequences, under
    vmap over "batch" and "data": [(params, metrics)] an epoch."""
    update_epoch = inspect.getclosurevars(update_step).nonlocals["_update_epoch"]
    u = len(seqs)
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs)[None], *trees)  # noqa: E731
    carry = (stack([jparams] * u), stack([jopt] * u), stack([jax_sequences(s) for s in seqs]),
             jax.random.split(jax.random.PRNGKey(seed), u)[None])
    fn = jax.jit(jax.vmap(jax.vmap(update_epoch, axis_name="batch"), axis_name="data"))
    out = []
    for _ in range(epochs):
        carry, metrics = fn(carry, None)
        out.append((carry[0], jax.tree.map(np.asarray, metrics)))
    return out


@pytest.mark.parametrize("update_batch", [1, 2])
def test_replay_epochs_match_jax_update_epoch(update_batch, monkeypatch):
    overrides = SMALL + REPLAY + [f"arch.update_batch_size={update_batch}",
                                  "system.multistep_impl=pallas", "env=identity_game",
                                  "arch.total_num_envs=8", "system.actor_lr=1e-3",
                                  "system.critic_lr=1e-3"]
    cfg, jcfg = compose(overrides)
    jsetup, update_step = jax_learner(jax_az, "get_replay_learner_fn", 4, jcfg, monkeypatch)
    jparams, jopts = replica(jsetup.learner_state.params), replica(jsetup.learner_state.opt_states)
    batch, seq_len = 6, 8
    seqs = [sequences(30 + u, batch, seq_len, 4) for u in range(update_batch)]
    want = jax_epochs(update_step, jparams, jopts, seqs, 2)

    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    actor, critic, params = port_actor_critic(env, cfg, jparams)
    optims = ff_ppo.make_optimizers(cfg)
    update = ff_az.AZReplayUpdate((ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic)),
                                  optims, cfg)
    opt = ActorCriticOptStates(optims[0].init(params.actor_params),
                               optims[1].init(params.critic_params))
    params, opts = [params] * update_batch, [opt] * update_batch
    batches = [port_sequences(s) for s in seqs]
    calls = _count_b1_calls(monkeypatch)
    for wparams, wmetrics in want:
        params, opts, metrics = update(params, opts, batches)
        for key in ("actor_loss", "entropy", "value_loss"):
            got = n(metrics[key]).reshape(update_batch)
            np.testing.assert_allclose(got, wmetrics[key][0], rtol=1e-5, atol=1e-6, err_msg=key)
        for u in range(update_batch):
            for side in ("actor_params", "critic_params"):
                for g, w in zip(jax.tree.leaves(to_flax_params(getattr(params[u], side),
                                                               getattr(jparams, side))),
                                jax.tree.leaves(getattr(wparams, side))):
                    np.testing.assert_allclose(g, np.asarray(w)[0, u], rtol=0, atol=1e-5)
    assert calls == {"gae": 2, "generic": 0}


def test_replay_rollout_stores_sequences_with_the_bootstrap_value():
    cfg, _ = compose(SMALL + SWEEP + REPLAY)
    setup = ff_az.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 3)
    state, traj = setup.learn.rollout(setup.learner_state)
    buffer = state.buffer_state
    assert set(buffer.experience) == {"obs", "search_policy", "search_value", "bootstrap_value",
                                      "reward", "discount", "truncated"}
    assert buffer.num_added == 8 and "info" in traj
    assert torch.equal(buffer.experience["search_value"][:, :8], traj["search_value"].T)
    # IdentityGame ends by termination only, at the 10th step.
    assert float(traj["truncated"].sum()) == 0.0
    np.testing.assert_allclose(n(traj["search_policy"].sum(-1)), 1.0, rtol=1e-6)
    assert traj["bootstrap_value"].shape == (8, 16)


def test_resume_after_window_one_is_bitwise_the_unbroken_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    window = 8 * 8

    def run(uid, windows, extra=()):
        config = config_lib.compose(
            config_lib.default_config_dir(), ROOT, SMALL + [
                "env=identity_game", "arch.total_num_envs=8", "system.rollout_length=8",
                "system.epochs=2", "system.num_minibatches=2", "system.num_simulations=4",
                "arch.num_eval_episodes=4", "logger.use_console=False",
                "logger.checkpointing.save_model=true",
                f"logger.checkpointing.save_args.checkpoint_uid={uid}",
                "logger.checkpointing.save_args.max_to_keep=~",
                f"arch.num_evaluation={windows}", f"arch.total_timesteps={windows * window}",
                *extra])
        ff_az.run_experiment(config, device="cpu")

    run("unbroken", 2)
    run("first", 1)
    run("resumed", 1, ["logger.checkpointing.load_model=true",
                       "logger.checkpointing.load_args.checkpoint_uid=first"])
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == window
    load = lambda uid: torch.load(  # noqa: E731
        os.path.join(tmp_path, "checkpoints", uid, "ff_az", str(2 * window), "state.pt"),
        weights_only=True)
    unbroken, resumed = load("unbroken"), load("resumed")
    assert unbroken.keys() == resumed.keys()
    assert any("generator" in key for key in unbroken)
    for key, value in unbroken.items():
        other = resumed[key]
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, other), key
        elif isinstance(value, dict):
            assert torch.equal(value["generator_state"], other["generator_state"]), key
        else:
            assert value == other, key
    assert unbroken["opt_states/actor_opt_state/count"] == 2 * 2 * 2


@pytest.mark.parametrize("extra,key", [(["system.update_guard=skip"], "system.update_guard"),
                                       (REPLAY + ["system.ent_coef=0.01"], "system.ent_coef")])
def test_knobs_the_reference_ignores_are_refused_naming_the_key(extra, key):
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOT, SWEEP + extra)
    with pytest.raises(NotImplementedError, match=key):
        ff_az.run_experiment(cfg, device="cpu")
