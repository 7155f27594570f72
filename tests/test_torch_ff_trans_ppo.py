"""Anakin Transformer-PPO of the PyTorch port against the JAX package.

1. One update step from identical parameters, a fixed numpy trajectory of
   windows and explicit per-epoch permutations, against the JAX package's own
   functions composed in stoix_tpu/systems/ppo/anakin/ff_trans_ppo.py's order
   (successor windows, one bootstrap critic pass, GAE, epochs x minibatches of
   loss + grad + clip + Adam). Tolerances (float32): GAE bitwise against the
   jitted JAX GAE on the same inputs; bootstrap values, advantages and
   minibatch losses 1e-5 relative; updated params 1e-5 absolute (gradients
   reduce in another order than XLA's).
2. The stateful evaluator carries one window per episode, clears it where an
   episode is done and freezes it with the episode once it has ended.
3. A 2-update smoke run on the CPU at tests/test_systems_sweep.py's
   ff_trans_ppo overrides, and `multistep_impl=pallas` training bitwise like
   `scan` (no kernel launches on the CPU).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu.ops import losses as jlosses
from stoix_tpu.ops.multistep import truncated_generalized_advantage_estimation as jax_gae
from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams
from stoix_tpu_torch.evaluator import get_rnn_evaluator_fn
from stoix_tpu_torch.kernels import flash_attention, linear_recurrence
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_trans_ppo
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import make_apply_fn
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from stoix_tpu_torch.utils.training import ClipAdam
from torch_parity import n, paired_window_networks, t, to_flax_params

ROOT = "default/anakin/default_ff_trans_ppo.yaml"
SMALL = ["system.window_length=4", "system.num_layers=1", "system.num_heads=2",
         "system.head_dim=8", "system.ffn_dim=32"]
SWEEP = [  # tests/test_systems_sweep.py: BASE + the ff_trans_ppo entry
    "arch.total_num_envs=16", "arch.num_evaluation=1", "arch.num_eval_episodes=8",
    "arch.absolute_metric=False", "system.rollout_length=8", "logger.use_console=False",
    "env=identity_game", "system.window_length=4", "system.num_layers=1",
    "system.num_minibatches=2",
]


def make_config(overrides):
    return config_lib.compose(config_lib.default_config_dir(), ROOT, overrides)


def _trajectory(seed, t_len, n_envs, window, obs_dim, num_actions):
    rng = np.random.default_rng(seed)
    windows = rng.normal(size=(t_len, n_envs, window, obs_dim)).astype(np.float32)
    windows[:, : n_envs // 2, :2] = 0.0  # cleared context: zero padding
    done = rng.uniform(size=(t_len, n_envs)) < 0.1
    return {
        "window": windows,
        "next_obs": rng.normal(size=(t_len, n_envs, obs_dim)).astype(np.float32),
        "action": rng.integers(0, num_actions, size=(t_len, n_envs)).astype(np.int32),
        "reward": rng.normal(size=(t_len, n_envs)).astype(np.float32),
        "value": rng.normal(size=(t_len, n_envs)).astype(np.float32),
        "log_prob": np.log(rng.uniform(0.2, 0.8, size=(t_len, n_envs))).astype(np.float32),
        "done": done,
        "truncated": (rng.uniform(size=(t_len, n_envs)) < 0.1) & ~done,
    }


def _jitted_gae(s):
    return jax.jit(functools.partial(jax_gae, standardize_advantages=False, impl="scan"))


def _jax_update(ja, jap, jc, jcp, traj, permutations, cfg):
    """ff_trans_ppo.py:117-224 on the JAX side, with explicit permutations."""
    s = cfg.system
    window = jnp.asarray(traj["window"])
    next_windows = jnp.concatenate(
        [window[:, :, 1:], jnp.asarray(traj["next_obs"])[:, :, None]], axis=2)
    v_t = jax.jit(jc.apply)(jcp, next_windows)
    d_t = s.gamma * (1.0 - jnp.asarray(traj["done"]).astype(jnp.float32))
    advantages, targets = _jitted_gae(s)(
        jnp.asarray(traj["reward"]), d_t, s.gae_lambda, v_tm1=jnp.asarray(traj["value"]),
        v_t=v_t, truncation_t=jnp.asarray(traj["truncated"]).astype(jnp.float32),
    )

    def actor_loss(params, window, action, old_log_prob, gae):
        dist = ja.apply(params, window)
        loss_actor = jlosses.ppo_clip_loss(dist.log_prob(action), old_log_prob, gae, s.clip_eps)
        entropy = dist.entropy().mean()
        return loss_actor - s.ent_coef * entropy, (loss_actor, entropy)

    def critic_loss(params, window, targets, old_value):
        value_loss = jlosses.clipped_value_loss(jc.apply(params, window), old_value, targets,
                                                s.clip_eps)
        return s.vf_coef * value_loss, value_loss

    make_optim = lambda: optax.chain(optax.clip_by_global_norm(float(s.max_grad_norm)),
                                     optax.adam(float(s.actor_lr), eps=1e-5))
    actor_optim, critic_optim = make_optim(), make_optim()
    actor_grad = jax.jit(jax.grad(actor_loss, has_aux=True))
    critic_grad = jax.jit(jax.grad(critic_loss, has_aux=True))
    actor_step, critic_step = jax.jit(actor_optim.update), jax.jit(critic_optim.update)
    a_state, c_state = actor_optim.init(jap), critic_optim.init(jcp)
    flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]),
                        (window, jnp.asarray(traj["action"]), jnp.asarray(traj["log_prob"]),
                         jnp.asarray(traj["value"]), advantages, targets))
    losses = []
    for perm in permutations:
        mbs = jax.tree.map(lambda x: jnp.take(x, jnp.asarray(perm), axis=0).reshape(
            (s.num_minibatches, -1) + x.shape[1:]), flat)
        for i in range(s.num_minibatches):
            mb_win, mb_act, mb_lp, mb_val, mb_adv, mb_tgt = jax.tree.map(lambda x: x[i], mbs)
            a_grads, (loss_actor, entropy) = actor_grad(jap, mb_win, mb_act, mb_lp, mb_adv)
            c_grads, value_loss = critic_grad(jcp, mb_win, mb_tgt, mb_val)
            updates, a_state = actor_step(a_grads, a_state)
            jap = optax.apply_updates(jap, updates)
            updates, c_state = critic_step(c_grads, c_state)
            jcp = optax.apply_updates(jcp, updates)
            losses.append([float(loss_actor), float(value_loss), float(entropy)])
    return np.asarray(v_t), np.asarray(advantages), np.asarray(losses), jap, jcp


def test_one_update_step_matches_jax_composition():
    cfg = make_config(SMALL + ["system.epochs=2", "system.num_minibatches=2",
                               "system.actor_lr=1.0e-3", "system.critic_lr=1.0e-3",
                               "system.standardize_advantages=false",
                               "arch.num_updates_per_eval=1"])
    t_len, n_envs, window, obs_dim, num_actions = 4, 8, 4, 6, 3
    ja, jap, jc, jcp, ta, tc = paired_window_networks(
        obs_dim, num_actions, window=window, num_layers=1, seed=5)
    traj = _trajectory(0, t_len, n_envs, window, obs_dim, num_actions)
    perms = [np.random.default_rng(10 + e).permutation(t_len * n_envs) for e in range(2)]
    want_v_t, want_adv, want_losses, want_ap, want_cp = _jax_update(
        ja, jap, jc, jcp, traj, perms, cfg)

    actor_params = {k: v.detach() for k, v in ta.named_parameters()}
    critic_params = {k: v.detach() for k, v in tc.named_parameters()}
    optims = tuple(ClipAdam(1e-3, cfg.system.max_grad_norm, eps=1e-5) for _ in range(2))
    critic_apply = make_apply_fn(tc)
    learner = ff_trans_ppo.get_learner_fn(None, (make_apply_fn(ta), critic_apply), optims, cfg)
    transition = ff_trans_ppo.TransPPOTransition(
        **{k: t(v) for k, v in traj.items()}, info={})
    result = learner.update(
        ActorCriticParams(actor_params, critic_params),
        ActorCriticOptStates(optims[0].init(actor_params), optims[1].init(critic_params)),
        transition, permutations=[torch.from_numpy(p) for p in perms],
    )

    # The bootstrap pass over the successor windows, then GAE: bitwise against
    # the jitted JAX GAE on the port's own bootstrap values.
    next_windows = torch.cat([t(traj["window"])[:, :, 1:], t(traj["next_obs"])[:, :, None]], 2)
    with torch.no_grad():
        v_t = critic_apply(critic_params, next_windows)
    np.testing.assert_allclose(n(v_t), want_v_t, rtol=1e-5, atol=1e-6)
    s = cfg.system
    same_inputs = _jitted_gae(s)(
        jnp.asarray(traj["reward"]), s.gamma * (1.0 - jnp.asarray(traj["done"], jnp.float32)),
        s.gae_lambda, v_tm1=jnp.asarray(traj["value"]), v_t=jnp.asarray(n(v_t)),
        truncation_t=jnp.asarray(traj["truncated"], jnp.float32))
    np.testing.assert_array_equal(n(result.advantages), np.asarray(same_inputs[0]))
    np.testing.assert_array_equal(n(result.targets), np.asarray(same_inputs[1]))
    np.testing.assert_allclose(n(result.advantages), want_adv, rtol=1e-5, atol=1e-6)

    got_losses = np.stack([n(result.loss_info[k]).reshape(-1)
                           for k in ("actor_loss", "value_loss", "entropy")], axis=1)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5, atol=1e-7)
    for got, want, before in ((result.params.actor_params, want_ap, jap),
                              (result.params.critic_params, want_cp, jcp)):
        got_tree = to_flax_params(got, want)
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5),
                     got_tree, want)
        moved = jax.tree.map(lambda g, w0: float(np.abs(g - w0).max()), got_tree, before)
        assert max(jax.tree.leaves(moved)) > 1e-4  # the update really moved the params


def _eval_setup(overrides, episodes):
    cfg = check_total_timesteps(make_config(
        SMALL + ["arch.total_num_envs=4", f"arch.num_eval_episodes={episodes}"] + overrides), 1)
    env, eval_env = envs.make(cfg)
    setup = ff_trans_ppo.learner_setup(env, cfg, torch.device("cpu"), seed=0)
    return cfg, eval_env, setup


def test_window_act_fn_clears_where_done_then_pushes():
    _, eval_env, setup = _eval_setup([], 2)
    _, timestep = eval_env.reset(torch.Generator().manual_seed(0), 2)
    ctx = torch.arange(2 * 4 * 4, dtype=torch.float32).reshape(2, 4, 4) + 1.0
    done = torch.tensor([True, False])
    new_ctx, action = setup.eval_act_fn(
        setup.learner_state.params.actor_params, ctx, timestep.observation, done,
        torch.Generator().manual_seed(1))
    obs = timestep.observation.agent_view
    assert action.shape == (2,)
    assert torch.equal(new_ctx[0, :3], torch.zeros(3, 4)) and torch.equal(new_ctx[0, 3], obs[0])
    assert torch.equal(new_ctx[1, :3], ctx[1, 1:]) and torch.equal(new_ctx[1, 3], obs[1])


def test_rnn_evaluator_carries_clears_and_freezes_windows():
    # CartPole under a sampled policy: episodes of different lengths in one batch.
    cfg, eval_env, setup = _eval_setup(["arch.evaluation_greedy=false"], 6)
    steps = []

    def recording_act_fn(params, ctx, observation, done, generator):
        new_ctx, action = setup.eval_act_fn(params, ctx, observation, done, generator)
        steps.append((ctx.clone(), observation.agent_view.clone(), new_ctx.clone()))
        return new_ctx, action

    def init_window(episodes):
        return torch.zeros((episodes, 4, 4))

    evaluator = get_rnn_evaluator_fn(eval_env, recording_act_fn, cfg, init_window)
    metrics = evaluator(setup.eval_params_fn(setup.learner_state), torch.Generator().manual_seed(3))
    lengths = metrics["episode_length"].long().tolist()
    assert len(set(lengths)) > 1 and len(steps) == max(lengths)
    assert set(metrics) == {"episode_return", "episode_length"}
    for i, length in enumerate(lengths):
        for s, (ctx, obs, new_ctx) in enumerate(steps):
            if s < length:
                # Running: the window holds the episode's last observations,
                # zero padding before its first.
                assert torch.equal(new_ctx[i, -1], obs[i])
                assert torch.count_nonzero(new_ctx[i, : max(0, 3 - s)]) == 0
                if s > 0:
                    assert torch.equal(new_ctx[i, :-1], ctx[i, 1:])
            else:
                # Ended: frozen, the window with it.
                assert torch.equal(ctx[i], steps[length - 1][2][i])
                assert torch.equal(obs[i], steps[length][1][i])


def test_two_update_smoke_on_cpu():
    cfg = make_config(SWEEP + ["arch.num_updates=2"])
    final_return = ff_trans_ppo.run_experiment(cfg, device="cpu")
    assert np.isfinite(final_return)
    stats = runner.LAST_RUN_STATS
    assert stats["device"] == "cpu" and len(stats["window_seconds"]) == 1
    train = [r for r in stats["history"] if r["event"] == "trainer"]
    assert train and set(train[0]) >= {"actor_loss", "value_loss", "entropy"}
    assert all(np.isfinite(v) for r in train for k, v in r.items() if k.endswith(("loss", "py")))


def test_pallas_trains_bitwise_like_scan_on_cpu():
    outcomes = {}
    before = [c.launches for c in (*flash_attention.COUNTERS, *linear_recurrence.COUNTERS)]
    for impl in ("scan", "pallas"):
        cfg = check_total_timesteps(make_config(SMALL + [
            "arch.total_num_envs=8", "arch.num_updates=1", "system.rollout_length=4",
            "system.epochs=1", "system.num_minibatches=2", f"system.multistep_impl={impl}"]), 1)
        env, _ = envs.make(cfg)
        setup = ff_trans_ppo.learner_setup(env, cfg, torch.device("cpu"), seed=3)
        state, traj = setup.learn.rollout(setup.learner_state)
        result = setup.learn.update(state.params, state.opt_states, traj, state.generator)
        outcomes[impl] = (result.advantages, result.params)
    assert torch.equal(outcomes["scan"][0], outcomes["pallas"][0])
    for part in range(2):
        for k, v in outcomes["scan"][1][part].items():
            assert torch.equal(v, outcomes["pallas"][1][part][k]), k
    # The CPU takes the plain versions: no kernel launched.
    assert [c.launches for c in (*flash_attention.COUNTERS, *linear_recurrence.COUNTERS)] == before


def test_entry_point_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ff_trans_ppo.run_experiment(make_config(["env=identity_game", "arch.total_num_envs=8"]))


@pytest.mark.parametrize("override,key", [
    # A mesh axis other than "data" (the JAX package's gossip groups, ROADMAP A17).
    ("arch.mesh.group=2", "arch.mesh.group"),
    ("arch.fault_spec=nan_loss:1", "arch.fault_spec"),
    # ff_ppo's knobs that the JAX package's ff_trans_ppo ignores (ROADMAP C9).
    ("system.normalize_observations=true", "system.normalize_observations"),
    ("system.update_guard=skip", "system.update_guard"),
    ("system.fused_update=true", "system.fused_update"),
    ("system.adaptive_kl_beta=true", "system.adaptive_kl_beta"),
])
def test_unported_knobs_raise_naming_the_key(override, key):
    cfg = make_config(["env=identity_game", "arch.total_num_envs=8", "arch.num_updates=1",
                       "arch.num_evaluation=1", override])
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        ff_trans_ppo.run_experiment(cfg, device="cpu")
