"""Anakin REINFORCE of the PyTorch port (stoix_tpu_torch/systems/vpg:
ff_reinforce and ff_reinforce_continuous) against the JAX package's, on the
CPU, at a small width (MLPs of 16 x 16).

1. One update step on an explicit [T, E] trajectory with truncations and
   terminations, from the same flax params, against JAX ff_reinforce.py's
   `_update_step` after its rollout (:70-118: the critic's v_tm1 and v_t, GAE
   at lambda = 1 over gamma . discount, the actor's and critic's losses,
   `pmean` over "batch", clip + Adam eps 1e-5) under
   `jax.vmap(axis_name="batch")`, jitted, for the Categorical head and the
   tanh-Gaussian one, at `update_batch_size` 1 and 2: the returns 1e-6
   absolute, losses 1e-5 relative with an absolute floor of 1e-6 (the
   actor loss is a mean of O(1) terms that can cancel to 3e-3, where the
   two packages' summation orders part by 2e-7), params 1e-5 absolute. Under
   `multistep_impl=pallas` the step calls B1's GAE entry exactly once (on
   the CPU its plain version) and its generic entry never.
2. Each system runs its default config to a finite return at the sweep's
   budget with one GAE call an update; IdentityGame above 8.0 at the
   overrides where the JAX package returns 10.0 (64 envs, T = 32, 65 536
   steps; scripts/jax_oracle_thresholds.py); `system.update_guard` is
   refused naming the key (C18).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.ops.multistep import truncated_generalized_advantage_estimation as jax_gae
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.systems import anakin
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.vpg import ff_reinforce, ff_reinforce_continuous
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam
from stoix_tpu_torch.utils.tree import tree_stack
from test_torch_continuous import _count_b1_calls, _paired_actor_critic, _trajectory
from torch_parity import n, t, to_flax_params

ROOTS = {"ff_reinforce": "default/anakin/default_ff_reinforce.yaml",
         "ff_reinforce_continuous": "default/anakin/default_ff_reinforce_continuous.yaml"}
MODULES = {"ff_reinforce": ff_reinforce, "ff_reinforce_continuous": ff_reinforce_continuous}


def _split(x, update_batch):  # [T, U.E, ...] -> [U, T, E, ...]
    x = jnp.asarray(x)
    return jnp.moveaxis(x.reshape(x.shape[:1] + (update_batch, -1) + x.shape[2:]), 1, 0)


def jax_update_fn(ja, jc, cfg, axes=("batch",)):
    """JAX ff_reinforce.py's update after the rollout (:70-118) on one
    replica's [T, E] trajectory, the gradients pmeaned over each of `axes`
    in turn: (params, opt states, trajectory) -> (params, opt states,
    losses (actor, entropy, value), targets)."""
    s = cfg.system
    make_optim = lambda lr: optax.chain(optax.clip_by_global_norm(float(s.max_grad_norm)),
                                        optax.adam(lr, eps=1e-5))
    aopt, copt = make_optim(float(s.actor_lr)), make_optim(float(s.critic_lr))
    gamma, ent_coef = float(s.gamma), float(s.get("ent_coef", 0.0))

    def update(params, states, tr):
        obs = JaxObservation(*(tr["obs"][k] for k in JaxObservation._fields))
        next_obs = JaxObservation(*(tr["next_obs"][k] for k in JaxObservation._fields))
        v_tm1 = jax.lax.stop_gradient(jc.apply(params[1], obs))
        v_t = jax.lax.stop_gradient(jc.apply(params[1], next_obs))
        _, g_t = jax_gae(tr["reward"], gamma * tr["discount"], 1.0, v_tm1=v_tm1, v_t=v_t,
                         truncation_t=tr["truncated"].astype(jnp.float32))

        def actor_loss_fn(p):
            dist = ja.apply(p, obs)
            loss = -jnp.mean(dist.log_prob(tr["action"]) * jax.lax.stop_gradient(g_t - v_tm1))
            entropy = dist.entropy().mean()
            return loss - ent_coef * entropy, (loss, entropy)

        def critic_loss_fn(p):
            loss = 0.5 * jnp.mean((jc.apply(p, obs) - jax.lax.stop_gradient(g_t)) ** 2)
            return loss, loss

        ag, (la, ent) = jax.grad(actor_loss_fn, has_aux=True)(params[0])
        cg, vl = jax.grad(critic_loss_fn, has_aux=True)(params[1])
        for axis in axes:
            ag, cg = jax.lax.pmean((ag, cg), axis_name=axis)
        au, a_s = aopt.update(ag, states[0])
        cu, c_s = copt.update(cg, states[1])
        return ((optax.apply_updates(params[0], au), optax.apply_updates(params[1], cu)),
                (a_s, c_s), jnp.stack([la, ent, vl]), g_t)

    return update, (aopt, copt)


def jax_update(ja, jap, jc, jcp, traj, cfg, update_batch):
    """`jax_update_fn` under vmap("batch") over U replicas (each its env
    columns). Returns the targets [U, T, E], the losses [U, 3] and the
    (actor, critic) params."""
    update, (aopt, copt) = jax_update_fn(ja, jc, cfg)
    trajs = jax.tree.map(lambda x: _split(x, update_batch), traj)
    step = jax.jit(jax.vmap(update, axis_name="batch", in_axes=(None, None, 0)))
    params, _, losses, targets = step((jap, jcp), (aopt.init(jap), copt.init(jcp)), trajs)
    return np.asarray(targets), np.asarray(losses), jax.tree.map(lambda x: x[0], params)


def port_trajectory(traj):
    as_obs = lambda o: Observation(*(t(o[k]) for k in Observation._fields))  # noqa: E731
    return {"obs": as_obs(traj["obs"]), "next_obs": as_obs(traj["next_obs"]),
            "action": t(traj["action"]), "log_prob": t(traj["log_prob"]),
            "reward": t(traj["reward"]), "discount": t(traj["discount"]),
            "truncated": t(traj["truncated"]), "info": {}}


def assert_params(got, want, update_batch):
    got = {k: v[0] if update_batch > 1 else v for k, v in got.items()}
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5),
                 to_flax_params(got, want), want)


@pytest.mark.parametrize("update_batch", [1, 2])
@pytest.mark.parametrize("system", list(ROOTS))
def test_one_update_step_matches_jax_composition(system, update_batch, monkeypatch):
    discrete = system == "ff_reinforce"
    overrides = [f"arch.update_batch_size={update_batch}", "arch.num_updates_per_eval=1",
                 "system.multistep_impl=pallas", "system.ent_coef=0.05"]
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS[system], overrides)
    jcfg = jax_config.compose(jax_config.default_config_dir(), ROOTS[system], overrides)
    t_len, n_envs, obs_dim, action_dim = 6, 8 * update_batch, 5, 3 if discrete else 2
    ja, jap, jc, jcp, ta, tc = _paired_actor_critic(discrete, obs_dim, action_dim, 4)
    traj = _trajectory(1, t_len, n_envs, obs_dim, action_dim, discrete, ja, jap)
    traj["discount"] = (~traj.pop("done")).astype(np.float32)
    want_targets, want_losses, (want_ap, want_cp) = jax_update(ja, jap, jc, jcp, traj, jcfg,
                                                               update_batch)

    optims = tuple(ClipAdam(float(cfg.system[k]), float(cfg.system.max_grad_norm), eps=1e-5)
                   for k in ("actor_lr", "critic_lr"))
    learner = ff_reinforce.ReinforceLearner(
        None, (ff_ppo.make_apply_fn(ta), ff_ppo.make_apply_fn(tc)), optims, cfg)
    params = ActorCriticParams({k: v.detach() for k, v in ta.named_parameters()},
                               {k: v.detach() for k, v in tc.named_parameters()})
    opt = ActorCriticOptStates(optims[0].init(params.actor_params),
                               optims[1].init(params.critic_params))
    if update_batch > 1:
        params, opt = tree_stack([params] * update_batch), tree_stack([opt] * update_batch)
    calls = _count_b1_calls(monkeypatch)
    tr = port_trajectory(traj)
    _, targets = learner.returns(anakin.split_replicas(params, update_batch), tr)
    calls["gae"] = 0
    new_params, _, metrics = learner.update(params, opt, tr)
    assert calls == {"gae": 1, "generic": 0}
    got_targets = n(targets).reshape(t_len, update_batch, -1).transpose(1, 0, 2)
    np.testing.assert_allclose(got_targets, want_targets, rtol=0, atol=1e-6)
    got_losses = np.stack([n(metrics[k]) for k in ("actor_loss", "entropy", "value_loss")], -1)
    np.testing.assert_allclose(got_losses.reshape(want_losses.shape), want_losses, rtol=1e-5,
                               atol=1e-6)
    assert_params(new_params.actor_params, want_ap, update_batch)
    assert_params(new_params.critic_params, want_cp, update_batch)


SWEEP = ["arch.total_num_envs=16", "arch.total_timesteps=2048", "arch.num_evaluation=1",
         "arch.num_eval_episodes=8", "arch.absolute_metric=False", "system.rollout_length=8",
         "logger.use_console=False", "system.multistep_impl=pallas"]


@pytest.mark.parametrize("system", list(ROOTS))
def test_each_system_runs_at_the_sweep_budget_with_one_gae_call_an_update(system, monkeypatch):
    calls = _count_b1_calls(monkeypatch)
    extra = ["env=identity_game"] if system == "ff_reinforce" else []
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS[system], SWEEP + extra)
    assert np.isfinite(MODULES[system].run_experiment(cfg, device="cpu"))
    assert calls == {"gae": 2048 // (16 * 8), "generic": 0}


def test_reinforce_learns_identity_game():
    import chip_smoke

    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS["ff_reinforce"],
                             chip_smoke.VPG_IDENTITY)
    assert ff_reinforce.run_experiment(cfg, device="cpu") > chip_smoke.PG_THRESHOLD


def test_update_guard_the_reference_ignores_is_refused_naming_the_key():
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS["ff_reinforce"],
                             SWEEP + ["system.update_guard=skip"])
    with pytest.raises(NotImplementedError, match="system.update_guard"):
        ff_reinforce.run_experiment(cfg, device="cpu")
