"""Anakin V-MPO of the PyTorch port (stoix_tpu_torch/systems/mpo: ff_vmpo,
ff_vmpo_continuous) and the dual helpers ff_mpo shares, against the JAX
package's, on the CPU, at a small width (MLPs of 16 x 16).

1. The helpers (`_softplus`, `project_duals`, `gaussian_params`,
   `gaussian_kls_per_dim`, `decomposed_dists`, `init_log_duals`,
   `decoupled_alpha_losses`) on the same inputs: 1e-6 relative; the top
   half's indices exactly `jnp.argsort(-adv)[:k]` on an input full of ties;
   the duals' plain Adam against `jax.jit` of `optax.adam(dual_lr)`.
2. Two update epochs (the second reading Adam's moments and refreshing the
   target at `actor_target_period` 2) on an explicit [T, E] trajectory
   whose env columns 0 and 1 differ only in the action (so their
   advantages tie), from the JAX package's own flax params, against JAX
   ff_vmpo.py's own `_update_epoch` (taken from its `learner_fn`'s closure)
   under `jax.vmap(axis_name="batch")` in `jax.vmap(axis_name="data")`,
   jitted, for the Categorical and the tanh-Gaussian policy at
   `update_batch_size` 1 and 2: losses 1e-5 relative, params and duals 1e-5
   absolute, the step count and the refresh exact, the chosen indices
   JAX's, and one call of B1's GAE entry an epoch (under `pallas`; on the
   CPU its plain version) with no gradient demanded of it.
3. The rollout acts with the TARGET actor; a resume after window 1 is
   bitwise the unbroken run (the duals, their Adam state and the step count
   carried); `system.update_guard` is refused naming the key (C19); each
   system at tests/test_systems_sweep.py's budget; IdentityGame above 8.0
   where the JAX package returns 10.0.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu import envs as jax_envs
from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.ops import distributions as jdists
from stoix_tpu.parallel.mesh import create_mesh
from stoix_tpu.systems.mpo import ff_vmpo as jax_vmpo
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import OnlineAndTarget
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.ops import distributions as tdists
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.mpo import ff_vmpo, ff_vmpo_continuous
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from test_torch_continuous import _count_b1_calls
from test_torch_ddpg import perturbed
from torch_parity import n, t, to_flax_params

ROOTS = {"ff_vmpo": "default/anakin/default_ff_vmpo.yaml",
         "ff_vmpo_continuous": "default/anakin/default_ff_vmpo_continuous.yaml"}
MODULES = {"ff_vmpo": ff_vmpo, "ff_vmpo_continuous": ff_vmpo_continuous}
SMALL = ["network.actor_network.pre_torso.layer_sizes=[16,16]",
         "network.critic_network.pre_torso.layer_sizes=[16,16]"]
SWEEP = ["arch.total_num_envs=16", "arch.total_timesteps=2048", "arch.num_evaluation=1",
         "arch.num_eval_episodes=8", "arch.absolute_metric=False", "system.rollout_length=8",
         "logger.use_console=False", "system.multistep_impl=pallas"]
T_LEN, ENVS = 8, 5


# ---------------------------------------------------------------- the helpers


def _gaussians(seed, shape=(7, 3)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) if i % 2 == 0 else
            np.exp(rng.normal(size=shape) * 0.3).astype(np.float32) for i in range(4)]


def test_softplus_and_projection_match_jax():
    x = np.array([-40.0, -19.0, -18.0, -17.5, -1e-3, 0.0, 0.7, 20.0, 30.0, 500.0], np.float32)
    np.testing.assert_allclose(n(ff_vmpo._softplus(t(x))), np.asarray(jax_vmpo._softplus(x)),
                               rtol=1e-6)
    got = ff_vmpo.project_duals(t(x[:3]), t(x.reshape(2, 5)))
    want = jax_vmpo.project_duals(x[:3], x.reshape(2, 5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))


@pytest.mark.parametrize("family", ["tanh", "mvn"])
def test_gaussian_helpers_and_decomposed_dists_match_jax(family):
    o_loc, o_scale, b_loc, b_scale = _gaussians(1)
    if family == "tanh":
        def make_t(loc, scale):
            return tdists.Independent(tdists.TanhNormal(t(loc), t(scale), -2.0, 2.0), 1)

        def make_j(loc, scale):
            return jdists.Independent(jdists.TanhNormal(loc, scale, -2.0, 2.0), 1)
    else:
        def make_t(loc, scale):
            return tdists.MultivariateNormalDiag(t(loc), t(scale))

        make_j = jdists.MultivariateNormalDiag
    online_t, target_t = make_t(o_loc, o_scale), make_t(b_loc, b_scale)
    online_j, target_j = make_j(o_loc, o_scale), make_j(b_loc, b_scale)
    for got, want in zip(ff_vmpo.gaussian_params(online_t), jax_vmpo.gaussian_params(online_j)):
        np.testing.assert_array_equal(n(got), np.asarray(want))
    kls = ff_vmpo.gaussian_kls_per_dim(*map(t, (b_loc, b_scale, o_loc, o_scale)))
    want = jax.jit(jax_vmpo.gaussian_kls_per_dim)(b_loc, b_scale, o_loc, o_scale)
    for got, w in zip(kls, want):
        assert got.shape == (3,)
        np.testing.assert_allclose(n(got), np.asarray(w), rtol=1e-6)
    actions = np.random.default_rng(2).uniform(-1.99, 1.99, (4, 7, 3)).astype(np.float32)
    for got_d, want_d in zip(ff_vmpo.decomposed_dists(target_t, online_t),
                             jax_vmpo.decomposed_dists(target_j, online_j)):
        np.testing.assert_allclose(n(got_d.log_prob(t(actions))),
                                   np.asarray(jax.vmap(want_d.log_prob)(actions)), rtol=1e-5)
        if family == "tanh":
            # minimum = _shift - _scale, rounded as JAX rounds it.
            inner_t, inner_j = got_d.distribution, want_d.distribution
            assert float(inner_t._shift - inner_t._scale) == float(inner_j._shift - inner_j._scale)


@pytest.mark.parametrize("continuous", [True, False])
def test_init_log_duals_and_alpha_losses_match_jax(continuous):
    overrides = ["system.init_log_alpha_stddev=50.0"] if continuous else []
    root = ROOTS["ff_vmpo_continuous" if continuous else "ff_vmpo"]
    cfg = config_lib.compose(config_lib.default_config_dir(), root, overrides)
    jcfg = jax_config.compose(jax_config.default_config_dir(), root, overrides)
    got = ff_vmpo.init_log_duals(cfg, continuous, 3)
    want = jax_vmpo.init_log_duals(jcfg, continuous, 3)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(n(g), np.asarray(w))
    log_alpha = np.array([[0.3, -1.0, 2.0], [4.0, 0.1, -0.5]], np.float32)
    kl_mean, kl_std = (np.abs(x[0]) for x in _gaussians(3)[:2])

    def jax_losses(la, km, ks):
        return jax_vmpo.decoupled_alpha_losses(la, km, ks, 0.05, 5e-4)

    want = jax.jit(jax_losses)(log_alpha, kl_mean, kl_std)
    got = ff_vmpo.decoupled_alpha_losses(t(log_alpha), t(kl_mean), t(kl_std), 0.05, 5e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-6)
    # Their gradients: alpha's loss moves only alpha, the KL penalty only the KLs.
    grads = torch.func.grad(lambda la, km: sum(ff_vmpo.decoupled_alpha_losses(
        la, km, t(kl_std), 0.05, 5e-4)[:2]), argnums=(0, 1))(t(log_alpha), t(kl_mean))
    want = jax.grad(lambda la, km: sum(jax_losses(la, km, kl_std)[:2]), argnums=(0, 1))(
        log_alpha, kl_mean)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-5)


def test_top_half_is_jax_stable_argsort_on_ties():
    rng = np.random.default_rng(4)
    for size in (1, 2, 7, 40, 1001):
        adv = np.round(rng.normal(size=size), 1).astype(np.float32)  # many ties
        adv[::5] = 0.0
        adv[1::7] = -0.0
        want = np.asarray(jax.jit(lambda a: jnp.argsort(-a)[:a.shape[0] // 2])(adv))
        got = ff_vmpo.top_half(t(adv)).numpy()
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(adv)) < len(adv) // 10


def test_dual_adam_matches_jitted_optax():
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS["ff_vmpo_continuous"], [])
    optim = ff_vmpo.make_dual_optimizer(cfg)
    jopt = optax.adam(float(cfg.system.dual_lr))
    duals = {"log_temperature": np.float32(10.0),
             "log_alpha": np.array([[10.0, 10.0], [500.0, 500.0]], np.float32)}
    rng = np.random.default_rng(5)
    port = ff_vmpo.dual_params(t(duals["log_temperature"]), t(duals["log_alpha"]))
    port_state, jstate, jparams = optim.init(port), jopt.init(duals), duals
    step = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *jopt.update(g, s)))
    for _ in range(6):
        grads = {k: (rng.normal(size=np.shape(v)) * 3).astype(np.float32)
                 for k, v in duals.items()}
        jparams, jstate = step(grads, jstate, jparams)
        updates, port_state = optim.update({k: t(v) for k, v in grads.items()}, port_state)
        port = {k: v + updates[k] for k, v in port.items()}
    for k in duals:
        np.testing.assert_allclose(n(port[k]), np.asarray(jparams[k]), rtol=0, atol=1e-6)
    assert port_state.count == 6 and optim.max_grad_norm is None and optim.eps == 1e-8


# ---------------------------------------------------------------- the epoch


def jax_learner(jcfg, monkeypatch):
    """JAX ff_vmpo.py's own `_update_epoch` (from its `learner_fn`'s
    closure) and its first replica's initial params and optimizer states,
    built by its `learner_setup` on a one-device mesh."""
    captured = {}
    original = jax_vmpo.get_learner_fn

    def capture(*args, **kwargs):
        captured["learn"] = original(*args, **kwargs)
        return captured["learn"]

    monkeypatch.setattr(jax_vmpo, "get_learner_fn", capture)
    env, _ = jax_envs.make(jcfg)
    mesh = create_mesh({"data": 1}, jax.devices()[:1])
    setup = jax_vmpo.learner_setup(env, jcfg, mesh, jax.random.PRNGKey(3))
    update_step = inspect.getclosurevars(captured["learn"]).nonlocals["_update_step"]
    update_epoch = inspect.getclosurevars(update_step).nonlocals["_update_epoch"]
    first = jax.tree.map(lambda x: np.asarray(x)[0], (setup.learner_state.params,
                                                      setup.learner_state.opt_states))
    return update_epoch, first[0], first[1]


def trajectory(seed, env, discrete):
    """[T, E] steps with terminations and truncations; env column 1 equals
    column 0 in everything but the action, so their advantages tie."""
    rng = np.random.default_rng(seed)
    obs_value = env.observation_value()
    obs_dim = int(obs_value.agent_view.shape[-1])
    mask_dim = int(obs_value.action_mask.shape[-1])
    lead = (T_LEN, ENVS)

    def obs():
        return {"agent_view": rng.normal(size=lead + (obs_dim,)).astype(np.float32),
                "action_mask": np.ones(lead + (mask_dim,), np.float32),
                "step_count": np.zeros(lead, np.int32)}

    done = rng.random(lead) < 0.12
    traj = {"obs": obs(), "next_obs": obs(),
            "reward": rng.normal(size=lead).astype(np.float32),
            "discount": (1.0 - done).astype(np.float32),
            "truncated": (rng.random(lead) < 0.1) & ~done}
    for key in ("obs", "next_obs"):
        for k, v in traj[key].items():
            v[:, 1] = v[:, 0]
    for key in ("reward", "discount", "truncated"):
        traj[key][:, 1] = traj[key][:, 0]
    traj["action"] = (rng.integers(0, mask_dim, lead).astype(np.int32) if discrete else
                      rng.uniform(-1.9, 1.9, lead + (1,)).astype(np.float32))
    if discrete:
        traj["action"][:, 1] = 1 - traj["action"][:, 0]
    return traj


def jax_trajectory(traj):
    out = dict(traj)
    for key in ("obs", "next_obs"):
        out[key] = JaxObservation(*(traj[key][k] for k in JaxObservation._fields))
    return out


def port_trajectory(trajs):
    """The replicas' [T, E_u] trajectories side by side as [T, U.E_u]."""
    def cat(*xs):
        return torch.from_numpy(np.concatenate(xs, axis=1))

    out = {k: cat(*(tr[k] for tr in trajs)) for k in ("reward", "discount", "truncated", "action")}
    for key in ("obs", "next_obs"):
        out[key] = Observation(*(cat(*(tr[key][k] for tr in trajs)) for k in Observation._fields))
    return out


def jax_epochs(update_epoch, jparams, jopt, trajs, epochs):
    """The JAX `_update_epoch` under vmap("batch") in vmap("data"), jitted;
    (params, metrics) after each epoch."""
    u = len(trajs)
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs)[None], *trees)  # noqa: E731
    carry = (stack([jparams] * u), stack([jopt] * u), stack([jax_trajectory(x) for x in trajs]))
    fn = jax.jit(jax.vmap(jax.vmap(update_epoch, axis_name="batch"), axis_name="data"))
    out = []
    for _ in range(epochs):
        carry, metrics = fn(carry, None)
        out.append((carry[0], jax.tree.map(np.asarray, metrics)))
    return out


def port_params(cfg, env, jparams, continuous):
    actor, critic = ff_ppo.build_networks(env, cfg, torch.Generator())

    def load(network, flax_params):
        load_flax_params(network, flax_params)
        return {k: v.detach().clone() for k, v in network.named_parameters()}

    params = ff_vmpo.VMPOParams(
        OnlineAndTarget(load(actor, jparams.actor_params.online),
                        load(actor, jparams.actor_params.target)),
        load(critic, jparams.critic_params), t(jparams.log_temperature), t(jparams.log_alpha),
        int(jparams.step_count))
    load_flax_params(actor, jparams.actor_params.online)
    return actor, critic, params


def assert_close_params(got, want, like, u):
    for g, w in zip(jax.tree.leaves(to_flax_params(got, like)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w)[0, u], rtol=0, atol=1e-5)


@pytest.mark.parametrize("update_batch", [1, 2])
@pytest.mark.parametrize("system", list(ROOTS))
def test_update_epochs_match_jax_update_epoch(system, update_batch, monkeypatch):
    continuous = system == "ff_vmpo_continuous"
    overrides = SMALL + [f"arch.update_batch_size={update_batch}", "system.actor_target_period=2",
                         "arch.total_num_envs=8", "system.multistep_impl=pallas"]
    cfg = check_total_timesteps(config_lib.compose(config_lib.default_config_dir(),
                                                   ROOTS[system], overrides), 1)
    jcfg = jax_config.compose(jax_config.default_config_dir(), ROOTS[system], overrides)
    update_epoch, jparams, jopt = jax_learner(jcfg, monkeypatch)
    # A target away from the online actor, so the KL and its refresh show.
    actor = jparams.actor_params
    jparams = jparams._replace(actor_params=actor._replace(target=perturbed(actor.target, 1)))
    env, _ = envs.make(cfg)
    trajs = [trajectory(10 + u, env, not continuous) for u in range(update_batch)]
    want = jax_epochs(update_epoch, jparams, jopt, trajs, 2)

    cfg.system.action_dim = env.num_actions
    actor, critic, params = port_params(cfg, env, jparams, continuous)
    optims = ff_vmpo.make_optimizers(cfg)
    learner = ff_vmpo.VMPOLearner(env, (ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic)),
                                  optims, cfg, continuous)
    opt = ff_vmpo.VMPOOptStates(
        optims[0].init(params.actor_params.online), optims[1].init(params.critic_params),
        optims[2].init(ff_vmpo.dual_params(params.log_temperature, params.log_alpha)))
    params, opts = [params] * update_batch, [opt] * update_batch
    traj = port_trajectory(trajs)

    # The top half of each replica's own T . E_u advantages, ties included,
    # as JAX's stable argsort picks it.
    advantages, _ = learner.advantages(params, traj)
    for u in range(update_batch):
        adv = advantages[:, u * ENVS:(u + 1) * ENVS].reshape(-1)
        assert torch.equal(adv.reshape(T_LEN, ENVS)[:, 0], adv.reshape(T_LEN, ENVS)[:, 1])
        want_idx = np.asarray(jax.jit(lambda a: jnp.argsort(-a)[:a.shape[0] // 2])(n(adv)))
        np.testing.assert_array_equal(ff_vmpo.top_half(adv).numpy(), want_idx)

    calls = _count_b1_calls(monkeypatch)
    from stoix_tpu_torch.kernels import linear_recurrence

    original = linear_recurrence.truncated_gae

    def no_grad_inputs(*args):
        assert not any(isinstance(a, torch.Tensor) and a.requires_grad for a in args)
        assert args[0].shape == (T_LEN, ENVS * update_batch)
        return original(*args)

    monkeypatch.setattr(linear_recurrence, "truncated_gae", no_grad_inputs)
    like = jparams.actor_params.online
    for epoch, (wparams, wmetrics) in enumerate(want):
        params, opts, metrics = learner.epoch(params, opts, traj)
        for key in ("policy_loss", "temperature", "kl", "value_loss"):
            got = n(metrics[key]).reshape(update_batch, -1)
            np.testing.assert_allclose(got.reshape(wmetrics[key].shape[1:]), wmetrics[key][0],
                                       rtol=1e-5, atol=1e-7, err_msg=key)
        for u in range(update_batch):
            assert params[u].step_count == epoch + 1 == int(np.asarray(wparams.step_count)[0, u])
            assert_close_params(params[u].actor_params.online, wparams.actor_params.online,
                                like, u)
            assert_close_params(params[u].actor_params.target, wparams.actor_params.target,
                                like, u)
            assert_close_params(params[u].critic_params, wparams.critic_params,
                                jparams.critic_params, u)
            for name in ("log_temperature", "log_alpha"):
                np.testing.assert_allclose(n(getattr(params[u], name)),
                                           np.asarray(getattr(wparams, name))[0, u], rtol=0,
                                           atol=1e-5)
        # The refresh at step 2 sets the target to the new online actor.
        refreshed = params[0].actor_params.target is params[0].actor_params.online
        assert refreshed == (epoch == 1)
    assert calls == {"gae": 2, "generic": 0}
    assert opts[0].dual_opt_state.count == 2


def test_rollout_acts_with_the_target_actor():
    cfg = check_total_timesteps(config_lib.compose(
        config_lib.default_config_dir(), ROOTS["ff_vmpo"],
        SMALL + SWEEP + ["env=identity_game"]), 1)
    setup = ff_vmpo.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 3)
    state = setup.learner_state
    # A target away from the online actor: the actions must be the target's.
    online = state.params.actor_params.online
    target = {k: torch.randn_like(v) for k, v in online.items()}
    state = state._replace(params=state.params._replace(
        actor_params=OnlineAndTarget(online, target)))
    replay = torch.Generator().set_state(state.generator.get_state())
    _, traj = setup.learn.rollout(state)
    first = setup.learn.actor_apply(target, state.timestep.observation).sample(replay)
    assert torch.equal(traj["action"][0], first)
    assert set(traj) == {"obs", "action", "reward", "discount", "truncated", "next_obs", "info"}


# ---------------------------------------------------------------- runs


def test_vmpo_resume_after_window_one_is_bitwise_the_unbroken_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    window = 2 * 8 * 8

    def run(uid, windows, extra=()):
        config = config_lib.compose(
            config_lib.default_config_dir(), ROOTS["ff_vmpo_continuous"], SMALL + [
                "arch.total_num_envs=8", "system.rollout_length=8", "system.epochs=3",
                "system.actor_target_period=4", "arch.num_eval_episodes=4",
                "logger.use_console=False", "logger.checkpointing.save_model=true",
                f"logger.checkpointing.save_args.checkpoint_uid={uid}",
                "logger.checkpointing.save_args.max_to_keep=~",
                f"arch.num_evaluation={windows}", f"arch.total_timesteps={windows * window}",
                *extra])
        ff_vmpo_continuous.run_experiment(config, device="cpu")

    run("unbroken", 2)
    run("first", 1)
    run("resumed", 1, ["logger.checkpointing.load_model=true",
                       "logger.checkpointing.load_args.checkpoint_uid=first"])
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == window
    load = lambda uid: torch.load(  # noqa: E731
        os.path.join(tmp_path, "checkpoints", uid, "ff_vmpo", str(2 * window), "state.pt"),
        weights_only=True)
    unbroken, resumed = load("unbroken"), load("resumed")
    assert unbroken.keys() == resumed.keys()
    for key, value in unbroken.items():
        other = resumed[key]
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, other), key
        elif isinstance(value, dict):
            assert torch.equal(value["generator_state"], other["generator_state"]), key
        else:
            assert value == other, key
    # 2 windows x 2 updates x 3 epochs; the duals moved and their Adam stepped.
    assert unbroken["params/step_count"] == 12
    assert unbroken["opt_states/dual_opt_state/count"] == 12
    assert not torch.equal(unbroken["params/log_alpha"], torch.tensor([[10.0], [500.0]]))


@pytest.mark.parametrize("system", list(ROOTS))
def test_update_guard_the_reference_ignores_is_refused_naming_the_key(system):
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS[system],
                             SWEEP + ["system.update_guard=skip"])
    with pytest.raises(NotImplementedError, match="system.update_guard"):
        MODULES[system].run_experiment(cfg, device="cpu")


@pytest.mark.parametrize("system", list(ROOTS))
def test_each_system_runs_at_the_sweep_budget_with_one_gae_call_an_epoch(system, monkeypatch):
    calls = _count_b1_calls(monkeypatch)
    extra = ["env=identity_game"] if system == "ff_vmpo" else []
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS[system], SWEEP + extra)
    assert np.isfinite(MODULES[system].run_experiment(cfg, device="cpu"))
    assert calls == {"gae": 2048 // (16 * 8) * 16, "generic": 0}


def test_vmpo_learns_identity_game():
    import chip_smoke

    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS["ff_vmpo"],
                             chip_smoke.VMPO_IDENTITY)
    assert ff_vmpo.run_experiment(cfg, device="cpu") > chip_smoke.MPO_THRESHOLD
