"""Recurrent PPO of the PyTorch port against the JAX package: ScannedRNN
(GRU and LSTM) with resets against flax, the recurrent actor and critic with
carried-across params, one rec_ppo update step against JAX's composition on
explicit inputs (params, trajectory, env permutations; also at
`update_batch_size` 2, and with the LSTM), the rollout's stored carries and
bootstrap values, `system.normalize_observations` (at U = 1 and 2), the
knobs the JAX rec_ppo ignores (refused, ROADMAP C12), and the IdentityGame
oracle.

Tolerances (float32): the RNN outputs and carries over T = 16 with resets,
and the actor's logits and critic's values, 1e-5 relative (1e-6 absolute
floor); update steps: advantages 1e-6 absolute, losses 1e-5 relative,
params 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.networks import base as jbase
from stoix_tpu.networks import heads as jheads
from stoix_tpu.networks import inputs as jinputs
from stoix_tpu.networks import torso as jtorso
from stoix_tpu.ops import losses as jlosses
from stoix_tpu.ops.multistep import truncated_generalized_advantage_estimation as jax_gae
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams
from stoix_tpu_torch.envs.types import Observation as TorchObservation
from stoix_tpu_torch.kernels import linear_recurrence
from stoix_tpu_torch.networks import base as tbase
from stoix_tpu_torch.networks import heads as theads
from stoix_tpu_torch.networks import inputs as tinputs
from stoix_tpu_torch.networks import torso as ttorso
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo, rec_ppo
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.tree import tree_map, tree_stack
from torch_parity import n, t, to_flax_params

RTOL, ATOL = 1e-5, 1e-6
ROOT = "default/anakin/default_rec_ppo.yaml"


def _tensor_tree(tree):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), tree)


def _random_carry(cell_type, hidden, batch_shape, rng):
    shape = tuple(batch_shape) + (hidden,)
    draw = lambda: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return (draw(), draw()) if cell_type in ("lstm", "optimised_lstm") else draw()


@pytest.mark.parametrize("cell_type", ["gru", "lstm", "optimised_lstm", "mgu", "simple"])
def test_scanned_rnn_with_resets_matches_flax(cell_type):
    """T = 16 steps from a non-zero carry, with resets at t = 0 and later:
    every output and the final carry against flax, and the reset oracle of
    tests/test_networks.py::test_scanned_rnn_resets_on_done (outputs from a
    reset on equal a fresh start's)."""
    t_len, batch, features, hidden = 16, 5, 4, 8
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(t_len, batch, features)).astype(np.float32)
    dones = rng.uniform(size=(t_len, batch)) < 0.15
    dones[0, 0], dones[3, :] = True, True
    h0 = _random_carry(cell_type, hidden, (batch,), rng)
    jrnn = jbase.ScannedRNN(hidden_size=hidden, cell_type=cell_type)
    jh0 = jax.tree.map(jnp.asarray, h0)
    params = jax.tree.map(np.asarray, jrnn.init(jax.random.PRNGKey(1), jh0,
                                                (jnp.asarray(xs), jnp.asarray(dones))))
    want_h, want_out = jrnn.apply(params, jh0, (jnp.asarray(xs), jnp.asarray(dones)))

    trnn = tbase.ScannedRNN(features, hidden, cell_type)
    load_flax_params(trnn, params)
    got_h, got_out = trnn(_tensor_tree(h0), (t(xs), t(dones)))
    np.testing.assert_allclose(n(got_out), np.asarray(want_out), rtol=RTOL, atol=ATOL)
    for got, want in zip(jax.tree.leaves(got_h), jax.tree.leaves(want_h)):
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=RTOL, atol=ATOL)

    fresh = tbase.ScannedRNN.initialize_carry(cell_type, hidden, (batch,))
    _, from_fresh = trnn(fresh, (t(xs[3:]), torch.zeros(t_len - 3, batch, dtype=torch.bool)))
    no_reset = np.zeros_like(dones)
    _, out_nodone = trnn(_tensor_tree(h0), (t(xs), t(no_reset)))
    after = dones.copy()
    after[:3] = False
    after[4:] = False
    _, out_done = trnn(_tensor_tree(h0), (t(xs), t(after)))
    np.testing.assert_allclose(n(out_done)[3:], n(from_fresh), atol=1e-6)
    assert not np.allclose(n(out_done)[3], n(out_nodone)[3])
    jfresh = jbase.ScannedRNN.initialize_carry(cell_type, hidden, (batch,))
    for got, want in zip(jax.tree.leaves(fresh), jax.tree.leaves(jfresh)):
        np.testing.assert_array_equal(n(got), np.asarray(want))


def _paired_recurrent(cell_type, obs_dim, num_actions, hidden=6, seed=0):
    """flax and port recurrent actor/critic pairs with identical params:
    (jax_actor, actor_params, jax_critic, critic_params, torch_actor,
    torch_critic); MLP pre- and post-torsos of 8."""
    def jax_parts():
        return dict(rnn=jbase.ScannedRNN(hidden_size=hidden, cell_type=cell_type),
                    pre_torso=jtorso.MLPTorso((8,)), post_torso=jtorso.MLPTorso((8,)),
                    input_layer=jinputs.ObservationInput())

    def torch_parts():
        return (tbase.ScannedRNN(8, hidden, cell_type), ttorso.MLPTorso(obs_dim, (8,)),
                ttorso.MLPTorso(hidden, (8,)), tinputs.ObservationInput())

    ja = jbase.RecurrentActor(action_head=jheads.CategoricalHead(num_actions), **jax_parts())
    jc = jbase.RecurrentCritic(critic_head=jheads.ScalarCriticHead(), **jax_parts())
    dummy = JaxObservation(jnp.zeros((1, 1, obs_dim)), jnp.ones((1, 1, num_actions)),
                           jnp.zeros((1, 1), jnp.int32))
    h = jbase.ScannedRNN.initialize_carry(cell_type, hidden, (1,))
    ka, kc = jax.random.split(jax.random.PRNGKey(seed))
    inputs = (dummy, jnp.zeros((1, 1), bool))
    jap = jax.tree.map(np.asarray, ja.init(ka, h, inputs))
    jcp = jax.tree.map(np.asarray, jc.init(kc, h, inputs))
    ta = tbase.RecurrentActor(theads.CategoricalHead(num_actions, 8), *torch_parts())
    tc = tbase.RecurrentCritic(theads.ScalarCriticHead(8), *torch_parts())
    load_flax_params(ta, jap)
    load_flax_params(tc, jcp)
    return ja, jap, jc, jcp, ta, tc


def _observations(rng, t_len, n_envs, obs_dim, num_actions):
    view = rng.normal(size=(t_len, n_envs, obs_dim)).astype(np.float32)
    mask = np.ones((t_len, n_envs, num_actions), np.float32)
    mask[..., -1] = rng.uniform(size=(t_len, n_envs)) < 0.7  # some actions masked
    steps = np.zeros((t_len, n_envs), np.int32)
    return {"agent_view": view, "action_mask": mask, "step_count": steps}


def _jax_obs(o):
    return JaxObservation(*(jnp.asarray(o[k]) for k in JaxObservation._fields))


def _torch_obs(o):
    return TorchObservation(*(t(o[k]) for k in TorchObservation._fields))


@pytest.mark.parametrize("cell_type", ["gru", "lstm"])
def test_recurrent_actor_and_critic_match_flax(cell_type):
    t_len, n_envs, obs_dim, num_actions, hidden = 16, 4, 5, 3, 6
    ja, jap, jc, jcp, ta, tc = _paired_recurrent(cell_type, obs_dim, num_actions, hidden)
    rng = np.random.default_rng(3)
    obs = _observations(rng, t_len, n_envs, obs_dim, num_actions)
    done = rng.uniform(size=(t_len, n_envs)) < 0.2
    h0 = _random_carry(cell_type, hidden, (n_envs,), rng)
    jh0 = jax.tree.map(jnp.asarray, h0)
    want_ah, want_dist = ja.apply(jap, jh0, (_jax_obs(obs), jnp.asarray(done)))
    want_ch, want_v = jc.apply(jcp, jh0, (_jax_obs(obs), jnp.asarray(done)))
    got_ah, got_dist = ta(_tensor_tree(h0), (_torch_obs(obs), t(done)))
    got_ch, got_v = tc(_tensor_tree(h0), (_torch_obs(obs), t(done)))
    np.testing.assert_allclose(n(got_dist.logits), np.asarray(want_dist.logits), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(n(got_v), np.asarray(want_v), rtol=RTOL, atol=ATOL)
    for got, want in zip(jax.tree.leaves((got_ah, got_ch)), jax.tree.leaves((want_ah, want_ch))):
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    back = to_flax_params(dict(ta.named_parameters()), jap)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, w), back, jap)


# ------------------------------------------------------------------ update step


def _trajectory(seed, cell_type, hidden, t_len, n_envs, obs_dim, num_actions, ja, jap):
    """A [T, E] rec_ppo trajectory: random carries at each step's start,
    reset flags, and the actor's own log-probs, re-unrolled from t = 0."""
    rng = np.random.default_rng(seed)
    obs = _observations(rng, t_len, n_envs, obs_dim, num_actions)
    entering_done = rng.uniform(size=(t_len, n_envs)) < 0.15
    hstates = tuple(_random_carry(cell_type, hidden, (t_len, n_envs), rng) for _ in range(2))
    action = np.argmax(rng.uniform(size=(t_len, n_envs, num_actions)) * obs["action_mask"],
                       -1).astype(np.int32)
    h0 = jax.tree.map(lambda x: jnp.asarray(x[0]), hstates[0])
    _, dist = ja.apply(jap, h0, (_jax_obs(obs), jnp.asarray(entering_done)))
    done = rng.uniform(size=(t_len, n_envs)) < 0.1
    return {
        "obs": obs, "entering_done": entering_done, "hstates": hstates, "action": action,
        "log_prob": np.asarray(dist.log_prob(jnp.asarray(action))),
        "value": rng.normal(size=(t_len, n_envs)).astype(np.float32),
        "bootstrap_value": rng.normal(size=(t_len, n_envs)).astype(np.float32),
        "reward": rng.normal(size=(t_len, n_envs)).astype(np.float32),
        "done": done, "truncated": (rng.uniform(size=(t_len, n_envs)) < 0.1) & ~done,
    }


def _jax_update(ja, jap, jc, jcp, traj, perms, cfg, update_batch):
    """JAX rec_ppo.py's _update_step after the rollout (:168-190) with its
    losses (:106-131), minibatches over envs (:152-166) and optax chain,
    under `jax.vmap(axis_name="batch")` over U replicas (each its own env
    columns and permutations, the gradients pmeaned). Returns advantages
    [U, T, E], losses [steps, U, 3] and the (identical) replicas' params."""
    s = cfg.system
    make_optim = lambda lr: optax.chain(optax.clip_by_global_norm(float(s.max_grad_norm)),  # noqa: E731
                                        optax.adam(lr, eps=1e-5))
    aopt, copt = make_optim(float(s.actor_lr)), make_optim(float(s.critic_lr))
    m = int(s.num_minibatches)

    def split(x):  # [T, U.E, ...] -> [U, T, E, ...]
        x = jnp.asarray(x)
        return jnp.moveaxis(x.reshape(x.shape[:1] + (update_batch, -1) + x.shape[2:]), 1, 0)

    def gae(tr):
        return jax_gae(tr["reward"], s.gamma * (1.0 - tr["done"].astype(jnp.float32)),
                       float(s.gae_lambda), v_tm1=tr["value"], v_t=tr["bootstrap_value"],
                       truncation_t=tr["truncated"].astype(jnp.float32),
                       standardize_advantages=True, impl="scan")

    def actor_loss(p, mb, advantages):
        init = jax.tree.map(lambda x: x[0], mb["hstates"][0])
        _, dist = ja.apply(p, init, (_jax_obs(mb["obs"]), mb["entering_done"]))
        loss = jlosses.ppo_clip_loss(dist.log_prob(mb["action"]), mb["log_prob"], advantages,
                                     float(s.clip_eps))
        entropy = dist.entropy().mean()
        return loss - float(s.ent_coef) * entropy, (loss, entropy)

    def critic_loss(p, mb, targets):
        init = jax.tree.map(lambda x: x[0], mb["hstates"][1])
        _, value = jc.apply(p, init, (_jax_obs(mb["obs"]), mb["entering_done"]))
        vl = jlosses.clipped_value_loss(value, mb["value"], targets, float(s.clip_eps))
        return float(s.vf_coef) * vl, vl

    def minibatch(params, states, batch):
        mb, advantages, targets = batch
        ag, (la, ent) = jax.grad(actor_loss, has_aux=True)(params[0], mb, advantages)
        cg, vl = jax.grad(critic_loss, has_aux=True)(params[1], mb, targets)
        ag, cg = jax.lax.pmean((ag, cg), "batch")
        au, a_s = aopt.update(ag, states[0])
        cu, c_s = copt.update(cg, states[1])
        return ((optax.apply_updates(params[0], au), optax.apply_updates(params[1], cu)),
                (a_s, c_s), jnp.stack([la, vl, ent]))

    trajs = jax.tree.map(split, traj)
    advantages, targets = jax.vmap(gae)(trajs)
    step = jax.jit(jax.vmap(minibatch, axis_name="batch", in_axes=(None, None, 0)))
    params, states, losses = (jap, jcp), (aopt.init(jap), copt.init(jcp)), []
    for epoch_perms in perms:
        mbs = []
        for u in range(update_batch):
            data = jax.tree.map(lambda x: x[u], (trajs, advantages, targets))
            shuffled = jax.tree.map(lambda x: jnp.take(x, jnp.asarray(epoch_perms[u]), axis=1),
                                    data)
            mbs.append(jax.tree.map(lambda x: jnp.stack(jnp.split(x, m, axis=1)), shuffled))
        for i in range(m):
            batch = jax.tree.map(lambda *xs: jnp.stack([x[i] for x in xs]), *mbs)
            new_params, new_states, loss = step(params, states, batch)
            params = jax.tree.map(lambda x: x[0], new_params)
            states = jax.tree.map(lambda x: x[0], new_states)
            losses.append(np.asarray(loss))
    return np.asarray(advantages), np.stack(losses), params


def _transition(traj):
    return rec_ppo.RNNPPOTransition(
        done=t(traj["done"]), truncated=t(traj["truncated"]),
        entering_done=t(traj["entering_done"]), action=t(traj["action"]),
        value=t(traj["value"]), reward=t(traj["reward"]),
        bootstrap_value=t(traj["bootstrap_value"]), log_prob=t(traj["log_prob"]),
        obs=_torch_obs(traj["obs"]), hstates=_tensor_tree(traj["hstates"]), info={})


def _learner(cfg, ta, tc, update_batch):
    params = ActorCriticParams({k: v.detach() for k, v in ta.named_parameters()},
                               {k: v.detach() for k, v in tc.named_parameters()})
    optims = ff_ppo.make_optimizers(cfg)
    opt = ActorCriticOptStates(optims[0].init(params.actor_params),
                               optims[1].init(params.critic_params))
    if update_batch > 1:
        params, opt = tree_stack([params] * update_batch), tree_stack([opt] * update_batch)
    learner = rec_ppo.get_learner_fn(None, (rec_ppo.make_apply_fn(ta), rec_ppo.make_apply_fn(tc)),
                                     optims, cfg)
    return learner, params, opt


@pytest.mark.parametrize("cell_type,update_batch", [("gru", 1), ("gru", 2), ("lstm", 1)])
def test_one_update_step_matches_jax_composition(cell_type, update_batch, monkeypatch):
    overrides = ["system.epochs=2", "system.num_minibatches=2", "system.actor_lr=1.0e-3",
                 "system.critic_lr=1.0e-3", f"arch.update_batch_size={update_batch}",
                 "arch.num_updates_per_eval=1", "system.multistep_impl=pallas"]
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOT, overrides)
    jcfg = jax_config.compose(jax_config.default_config_dir(), ROOT, overrides)
    t_len, n_envs, obs_dim, num_actions, hidden = 6, 4 * update_batch, 5, 3, 6
    ja, jap, jc, jcp, ta, tc = _paired_recurrent(cell_type, obs_dim, num_actions, hidden, seed=2)
    traj = _trajectory(0, cell_type, hidden, t_len, n_envs, obs_dim, num_actions, ja, jap)
    per = n_envs // update_batch
    perms = [[np.random.default_rng(10 + 2 * e + u).permutation(per) for u in range(update_batch)]
             for e in range(2)]
    want_adv, want_losses, (want_ap, want_cp) = _jax_update(ja, jap, jc, jcp, traj, perms, jcfg,
                                                            update_batch)

    learner, params, opt = _learner(cfg, ta, tc, update_batch)
    calls = {"gae": 0}
    gae = linear_recurrence.truncated_gae

    def counted(*args, **kwargs):
        calls["gae"] += 1
        return gae(*args, **kwargs)

    monkeypatch.setattr(linear_recurrence, "truncated_gae", counted)
    given = [torch.from_numpy(p[0]) if update_batch == 1 else [torch.from_numpy(q) for q in p]
             for p in perms]
    result = learner.update(params, opt, _transition(traj), permutations=given)
    assert calls["gae"] == 1  # B1's GAE entry once over [T, U.E]: one launch on the card

    got_adv = n(result.advantages).reshape(t_len, update_batch, -1).transpose(1, 0, 2)
    np.testing.assert_allclose(got_adv, want_adv, rtol=0, atol=1e-6)
    got_losses = np.stack([n(result.loss_info[k]) for k in ("actor_loss", "value_loss",
                                                            "entropy")], axis=-1)
    np.testing.assert_allclose(got_losses.reshape(want_losses.shape), want_losses, rtol=1e-5,
                               atol=1e-7)
    for got, want in ((result.params.actor_params, want_ap), (result.params.critic_params, want_cp)):
        for u in range(update_batch):
            replica = {k: v[u] if update_batch > 1 else v for k, v in got.items()}
            jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                                                 atol=1e-5),
                         to_flax_params(replica, want), want)
    moved = jax.tree.map(lambda g, w: float(np.abs(g - w).max()),
                         to_flax_params({k: v[0] if update_batch > 1 else v
                                         for k, v in result.params.actor_params.items()}, jap), jap)
    assert max(jax.tree.leaves(moved)) > 1e-4


# ------------------------------------------------------------------ the system


def _config(overrides):
    return config_lib.compose(config_lib.default_config_dir(), ROOT, [
        "env=identity_game", "arch.total_num_envs=8", "system.rollout_length=4",
        "system.num_minibatches=2", "logger.use_console=False", *overrides])


def test_rollout_stores_the_carries_the_update_re_unrolls_from():
    """Re-unrolling the rollout's actor and critic over the whole [T, E]
    trajectory from the stored carries at t = 0 with `entering_done` gives
    back the stored log-probs and values, and each bootstrap value is the
    critic's read of the true next observation from the post-step carry:
    what the JAX rec_ppo relies on for its minibatch re-unrolls."""
    cfg = _config(["arch.num_updates=1", "arch.num_evaluation=1",
                   "network.rnn_hidden_size=8", "system.rollout_length=12"])
    from stoix_tpu_torch import envs
    from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps

    cfg = check_total_timesteps(cfg, 1)
    env, _ = envs.make(cfg)
    setup = rec_ppo.learner_setup(env, cfg, torch.device("cpu"), seed=3)
    learner, state = setup.learn, setup.learner_state
    state, traj = learner.rollout(state)
    assert bool(traj.entering_done[1:].any()), "no episode ended inside the rollout"
    params = state.params
    h0 = tree_map(lambda x: x[0], traj.hstates)
    with torch.no_grad():
        _, dist = learner.actor_apply(params.actor_params, h0[0], (traj.obs, traj.entering_done))
        _, value = learner.critic_apply(params.critic_params, h0[1],
                                        (traj.obs, traj.entering_done))
    np.testing.assert_allclose(n(dist.log_prob(traj.action)), n(traj.log_prob), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(n(value), n(traj.value), rtol=1e-5, atol=1e-6)
    # The next step's stored start carry is this step's post-step carry.
    for k in (0, 1):
        with torch.no_grad():
            h_next, _ = (learner.actor_apply if k == 0 else learner.critic_apply)(
                params[k], traj.hstates[k][0], tree_map(lambda x: x[:1], (traj.obs,
                                                                         traj.entering_done)))
        np.testing.assert_allclose(n(h_next), n(traj.hstates[k][1]), rtol=1e-5, atol=1e-6)
    assert torch.equal(state.done | state.truncated, traj.done[-1] | traj.truncated[-1])


@pytest.mark.parametrize("update_batch", [1, 2])
def test_normalize_observations_scores_with_the_rollouts_statistics_then_folds(update_batch):
    """Under `system.normalize_observations` the rollout acts on observations
    normalised with the pre-update statistics, the update re-unrolls on the
    same normalised observations, and the raw ones are folded in after: the
    statistics count T . U . E more, and the re-unroll from the stored
    carries gives back the stored log-probs."""
    from stoix_tpu_torch import envs
    from stoix_tpu_torch.ops import running_statistics
    from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps

    cfg = check_total_timesteps(_config([
        "arch.num_updates=2", "arch.num_evaluation=1", "network.rnn_hidden_size=8",
        "system.normalize_observations=true", f"arch.update_batch_size={update_batch}"]), 1)
    env, _ = envs.make(cfg)
    setup = rec_ppo.learner_setup(env, cfg, torch.device("cpu"), seed=5)
    learner, state = setup.learn, setup.learner_state
    state, _ = learner.update_step(state)  # statistics away from their initial values
    before = state.obs_stats
    rolled, traj = learner.rollout(state)
    normalized = running_statistics.normalize_observation(traj.obs, before)
    params = learner.replicas(rolled.params)[0]
    h0 = tree_map(lambda x: x[0], learner.group(traj.hstates[0], 0, 1))
    with torch.no_grad():
        _, dist = learner.actor_apply(params.actor_params, h0, learner.group(
            (normalized, traj.entering_done), 0, 1))
    np.testing.assert_allclose(n(dist.log_prob(learner.group(traj.action, 0, 1))),
                               n(learner.group(traj.log_prob, 0, 1)), rtol=1e-5, atol=1e-6)
    after, _ = learner.update_step(state)
    assert float(after.obs_stats.count - before.count) == 4 * 8
    assert all(bool(torch.isfinite(v).all()) for v in after.params.actor_params.values())


@pytest.mark.parametrize("override,key", [
    ("system.update_guard=skip", "system.update_guard"),
    ("system.fused_update=true", "system.fused_update"),
    ("system.adaptive_kl_beta=true", "system.adaptive_kl_beta"),
    ("system.reward_scale=0.1", "system.reward_scale"),
    # Two data shards in one process: JAX's create_mesh ValueError ("do not cover").
    ("arch.mesh.data=2", "arch.mesh.data"),
])
def test_knobs_the_reference_ignores_raise_naming_the_key(override, key):
    """ROADMAP C12: the JAX rec_ppo silently ignores update_guard,
    fused_update, adaptive_kl_beta and reward_scale; the port refuses each,
    and a mesh its processes do not cover."""
    cfg = _config(["arch.num_updates=1", "arch.num_evaluation=1", override])
    with pytest.raises((NotImplementedError, ValueError), match=key.replace(".", r"\.")):
        rec_ppo.run_experiment(cfg, device="cpu")


@pytest.mark.parametrize("cell_type", ["optimised_lstm", "mgu", "simple"])
def test_rec_ppo_runs_every_rnn_cell(cell_type):
    """`network.rnn_cell_type` takes the three cells that were refused before
    ROADMAP A9b: one update of rec_ppo through each, finite, with the
    evaluator's carries of the cell's structure."""
    cfg = _config(["arch.num_updates=1", "arch.num_evaluation=1", "arch.num_eval_episodes=4",
                   f"network.rnn_cell_type={cell_type}"])
    assert np.isfinite(rec_ppo.run_experiment(cfg, device="cpu"))
    train = [r for r in runner.LAST_RUN_STATS["history"] if r["event"] == "trainer"]
    assert train and all(np.isfinite(v) for r in train for k, v in r.items()
                         if k not in ("event", "t", "t_eval"))


def test_rec_ppo_learns_identity_game_on_cpu():
    """The JAX rec_ppo returns 10.0 with these overrides on the CPU (64 envs,
    32 768 steps; seeds 42 and 1, and at 65 536 steps)."""
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOT, [
        "env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=32768",
        "arch.num_evaluation=1", "arch.num_eval_episodes=32", "arch.evaluation_greedy=True",
        "arch.absolute_metric=False", "logger.use_console=False"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        final_return = rec_ppo.run_experiment(cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert final_return > 8.0, f"rec_ppo failed to learn IdentityGame: {final_return}"
    assert runner.LAST_RUN_STATS["device"] == "cpu"


def test_entry_point_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(["arch.num_updates=1", "arch.num_evaluation=1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rec_ppo.run_experiment(cfg)
