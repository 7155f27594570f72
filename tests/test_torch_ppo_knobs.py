"""Anakin PPO's main-path knobs in the PyTorch port, against the JAX
package's ff_ppo (stoix_tpu/systems/ppo/anakin/ff_ppo.py) on the same numpy
inputs.

- `system.fused_update`: the fused gradients are bitwise the two-pass ones,
  and within 1e-5 of `jax.grad` of the JAX joint loss (`_fused_loss_fn`'s
  composition).
- `system.update_guard`: `off` is bitwise the unguarded update and adds no
  metric; `skip` keeps the pre-update params and moments (bitwise) while the
  step count advances; `halt` raises DivergenceError naming the step; the
  loss is poisoned with a monkeypatch (the JAX tests poison it through
  STOIX_TPU_FAULT, which the port does not take).
- `system.adaptive_kl_beta`: the doubling and halving rule exactly as JAX's;
  JAX's ValueError with the clip loss; β adapted from the measured KL with a
  loss that consumes it.
- `system.normalize_observations`: the update step normalises the
  trajectory with the pre-update statistics and then folds the raw
  observations in, against JAX's functions at 4e-6 of each statistic's
  largest entry: 128 samples summed in another order (about 32 ulps; the
  functions themselves are held at 1e-6 in test_torch_running_statistics.py).
- `arch.update_batch_size = 2`: one update step against JAX's composed
  update under `jax.vmap(axis_name="batch")` with `pmean` over "batch", at
  1e-5 as test_torch_ff_ppo.py's single-replica step; one GAE call an update.
- With every knob on, IdentityGame learns past 8.0 (the JAX oracle).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu.ops import losses as jlosses
from stoix_tpu.ops import running_statistics as jrs
from stoix_tpu.ops.multistep import truncated_generalized_advantage_estimation as jax_gae
from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams, PPOTransition
from stoix_tpu_torch.envs.types import Observation as TorchObservation
from stoix_tpu_torch.ops import losses as tlosses
from stoix_tpu_torch.ops import running_statistics as rs
from stoix_tpu_torch.resilience.errors import DivergenceError
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils.training import ClipAdam
from stoix_tpu_torch.utils.tree import tree_stack
from test_torch_ff_ppo import IDENTITY_OVERRIDES, _trajectory, make_config
from torch_parity import n, paired_networks, t, to_flax_params

OBS_DIM, NUM_ACTIONS = 6, 3
TINY = ["env=identity_game", "arch.total_num_envs=8", "arch.num_updates=4",
        "arch.num_evaluation=2", "arch.num_eval_episodes=4", "arch.absolute_metric=False",
        "system.rollout_length=4", "system.epochs=2", "system.num_minibatches=2",
        "logger.use_console=False"]


def _setup(overrides, seed=4, policy_loss_fn=None):
    cfg = make_config(["system.epochs=2", "system.num_minibatches=4", "system.actor_lr=1.0e-3",
                       "system.critic_lr=1.0e-3", "arch.num_updates_per_eval=1", *overrides])
    ja, jap, jc, jcp, ta, tc = paired_networks(OBS_DIM, NUM_ACTIONS, (32, 32), seed=seed)
    optims = tuple(ClipAdam(1e-3, cfg.system.max_grad_norm, eps=1e-5) for _ in range(2))
    learner = ff_ppo.get_learner_fn(
        None, (ff_ppo.make_apply_fn(ta), ff_ppo.make_apply_fn(tc)), optims, cfg, policy_loss_fn)
    params = ActorCriticParams({k: v.detach() for k, v in ta.named_parameters()},
                               {k: v.detach() for k, v in tc.named_parameters()})
    opt_states = ActorCriticOptStates(optims[0].init(params.actor_params),
                                      optims[1].init(params.critic_params))
    return cfg, (ja, jap, jc, jcp), learner, params, opt_states


def _transition(traj):
    as_obs = lambda o: TorchObservation(*(t(o[k]) for k in TorchObservation._fields))  # noqa: E731
    return PPOTransition(
        done=t(traj["done"]), truncated=t(traj["truncated"]), action=t(traj["action"]),
        value=t(traj["value"]), reward=t(traj["reward"]), log_prob=t(traj["log_prob"]),
        obs=as_obs(traj["obs"]), next_obs=as_obs(traj["next_obs"]), info={},
    )


def _perms(count, size, seed=10):
    return [torch.from_numpy(np.random.default_rng(seed + e).permutation(size))
            for e in range(count)]


def _assert_params_equal(a, b):
    for side in ("actor_params", "critic_params"):
        for k, v in getattr(a, side).items():
            assert torch.equal(v, getattr(b, side)[k]), (side, k)


# ------------------------------------------------------------------ fused update


def test_fused_update_is_bitwise_the_two_pass_update():
    traj = _transition(_trajectory(0, 8, 16, OBS_DIM, NUM_ACTIONS))
    results = []
    for fused in ("false", "true"):
        _, _, learner, params, opt_states = _setup([f"system.fused_update={fused}"])
        results.append(learner.update(params, opt_states, traj, permutations=_perms(2, 128)))
    _assert_params_equal(results[0].params, results[1].params)
    for side in ("actor_opt_state", "critic_opt_state"):
        a, b = getattr(results[0].opt_states, side), getattr(results[1].opt_states, side)
        assert a.count == b.count and all(torch.equal(a.mu[k], b.mu[k]) for k in a.mu)
    for key, value in results[0].loss_info.items():
        assert torch.equal(value, results[1].loss_info[key]), key


def test_fused_gradients_match_jax_grad_of_the_joint_loss():
    cfg, (ja, jap, jc, jcp), learner, params, _ = _setup(["system.fused_update=true"])
    raw = _trajectory(1, 2, 16, OBS_DIM, NUM_ACTIONS)
    rng = np.random.default_rng(2)
    advantages = rng.normal(size=(32,)).astype(np.float32)
    targets = rng.normal(size=(32,)).astype(np.float32)
    flat = lambda x: np.asarray(x).reshape((32,) + np.shape(x)[2:])  # noqa: E731
    obs = {k: flat(v) for k, v in raw["obs"].items()}
    action, log_prob, value = flat(raw["action"]), flat(raw["log_prob"]), flat(raw["value"])
    s = cfg.system
    from stoix_tpu.envs.types import Observation

    jobs = Observation(*(jnp.asarray(obs[k]) for k in Observation._fields))

    def joint(both):  # ff_ppo.py:200-215, the clip loss and the clipped value loss
        actor_params, critic_params = both
        dist = ja.apply(actor_params, jobs)
        loss_actor = jlosses.ppo_clip_loss(dist.log_prob(jnp.asarray(action)),
                                           jnp.asarray(log_prob), jnp.asarray(advantages),
                                           s.clip_eps)
        actor_total = loss_actor - s.ent_coef * dist.entropy().mean()
        value_loss = jlosses.clipped_value_loss(jc.apply(critic_params, jobs), jnp.asarray(value),
                                                jnp.asarray(targets), s.clip_eps)
        return actor_total + s.vf_coef * value_loss

    want = jax.grad(joint)((jap, jcp))
    batch = (TorchObservation(*(t(obs[k]) for k in TorchObservation._fields)), t(action),
             t(log_prob), t(value), t(advantages), t(targets))
    actor_grads, critic_grads, _ = learner.gradients(params, batch, params.actor_params, None)
    for got, w in ((actor_grads, want[0]), (critic_grads, want[1])):
        jax.tree.map(lambda g, x: np.testing.assert_allclose(g, np.asarray(x), rtol=0, atol=1e-5),
                     to_flax_params(got, w), w)


# ------------------------------------------------------------------ update guard


def _poison_second_call(monkeypatch, every=False):
    """The clip loss is NaN, and so are its gradients, on its second call
    (or on every call from the second on)."""
    calls = {"n": 0}
    clip = tlosses.ppo_clip_loss

    def poisoned(*args, **kwargs):
        calls["n"] += 1
        loss = clip(*args, **kwargs)
        return loss * float("nan") if calls["n"] == 2 or (every and calls["n"] > 2) else loss

    monkeypatch.setattr(tlosses, "ppo_clip_loss", poisoned)


def test_update_guard_off_is_bitwise_the_unguarded_update():
    traj = _transition(_trajectory(3, 8, 16, OBS_DIM, NUM_ACTIONS))
    results = {}
    for mode in ("off", "skip", "halt"):
        _, _, learner, params, opt_states = _setup([f"system.update_guard={mode}"])
        results[mode] = learner.update(params, opt_states, traj, permutations=_perms(2, 128))
    for mode in ("skip", "halt"):  # a finite update is selected as it is
        _assert_params_equal(results["off"].params, results[mode].params)
        assert set(results[mode].loss_info) - set(results["off"].loss_info) == {
            "skipped_updates", "guard_loss", "guard_grad_norm"}
        assert float(results[mode].loss_info["skipped_updates"].sum()) == 0.0
    assert set(results["off"].loss_info) == {"total_loss", "actor_loss", "value_loss", "entropy"}


def test_update_guard_skip_keeps_the_pre_update_state_and_advances_the_count(monkeypatch):
    traj = _transition(_trajectory(4, 8, 16, OBS_DIM, NUM_ACTIONS))
    _, _, learner, params, opt_states = _setup(["system.update_guard=skip", "system.epochs=1",
                                                "system.num_minibatches=2"])
    seen = []
    step = learner._update_minibatch

    def record(*args):
        out = step(*args)
        seen.append(out[:2])
        return out

    clean = learner.update(params, opt_states, traj, permutations=_perms(1, 128))
    _poison_second_call(monkeypatch)
    learner._update_minibatch = record
    poisoned = learner.update(params, opt_states, traj, permutations=_perms(1, 128))
    np.testing.assert_array_equal(n(poisoned.loss_info["skipped_updates"]), [[0.0, 1.0]])
    first_params, first_opt = seen[0][0][0], seen[0][1][0]
    _assert_params_equal(poisoned.params, first_params)
    for side in ("actor_opt_state", "critic_opt_state"):
        got, kept = getattr(poisoned.opt_states, side), getattr(first_opt, side)
        assert got.count == 2 == getattr(clean.opt_states, side).count  # advanced
        assert all(torch.equal(got.mu[k], kept.mu[k]) and torch.equal(got.nu[k], kept.nu[k])
                   for k in got.mu)


@pytest.mark.parametrize("update_batch", [1, 2])
def test_skip_run_ends_finite_with_one_skipped_update(monkeypatch, update_batch):
    # tests/test_resilience.py::test_nan_loss_skip_counter_exact_with_update_batch:
    # one poisoned update counts once, whatever U.
    _poison_second_call(monkeypatch)
    ret = ff_ppo.run_experiment(make_config(TINY + ["system.update_guard=skip",
                                                    f"arch.update_batch_size={update_batch}"]),
                                device="cpu")
    assert np.isfinite(ret)
    assert runner.LAST_RUN_STATS["resilience"]["skipped_updates"] == 1.0
    train = [rec for rec in runner.LAST_RUN_STATS["history"] if rec["event"] == "trainer"]
    assert all(np.isfinite(rec["actor_loss"]) for rec in train[1:])


def test_halt_raises_divergence_error_naming_the_step(monkeypatch):
    _poison_second_call(monkeypatch)
    with pytest.raises(DivergenceError) as err:
        ff_ppo.run_experiment(make_config(TINY + ["system.update_guard=halt"]), device="cpu")
    assert err.value.metric == "loss" and not np.isfinite(err.value.loss)
    assert err.value.step == 2 * 4 * 8  # the first window: 2 updates of 4 steps x 8 envs


def test_guard_off_lets_a_poisoned_update_poison_the_params(monkeypatch):
    traj = _transition(_trajectory(5, 8, 16, OBS_DIM, NUM_ACTIONS))
    _, _, learner, params, opt_states = _setup(["system.epochs=1", "system.num_minibatches=2"])
    _poison_second_call(monkeypatch)
    result = learner.update(params, opt_states, traj, permutations=_perms(1, 128))
    assert not all(torch.isfinite(v).all() for v in result.params.actor_params.values())


# ------------------------------------------------------------------ adaptive KL


def test_adaptive_kl_rule_matches_jax():
    target = 0.01
    betas = np.array([1e-3, 0.5, 3.0, 999.0], np.float32)
    kls = np.array([0.0, 0.005, 0.0066, 0.0067, 0.01, 0.015, 0.0151, 1.0], np.float32)
    for beta in betas:
        for kl in kls:
            # stoix_tpu/systems/ppo/anakin/ff_ppo.py:421-423
            want = jnp.where(kl > 1.5 * target, beta * 2.0, beta)
            want = jnp.where(kl < target / 1.5, want / 2.0, want)
            want = jnp.clip(want, 1e-3, 1e3)
            got = ff_ppo.adapt_kl_beta(t(beta), t(kl), target)
            assert n(got) == np.asarray(want), (beta, kl)


def test_adaptive_kl_with_the_clip_loss_raises_as_jax_does():
    with pytest.raises(ValueError, match="adaptive_kl_beta=true requires a policy loss"):
        ff_ppo.run_experiment(make_config(TINY + ["system.adaptive_kl_beta=true"]), device="cpu")


def _kl_penalty_loss(dist, action, old_log_prob, gae, config, behavior_dist=None, beta=None):
    ratio = torch.exp(dist.log_prob(action) - old_log_prob)
    kl = behavior_dist.kl_divergence(dist).mean()
    return -(ratio * gae).mean() + beta * kl, dist.entropy().mean()


_kl_penalty_loss.uses_kl_beta = True


@pytest.mark.parametrize("kl_target", [1e-9, 1e9])
def test_adaptive_kl_adapts_beta_from_the_measured_kl(kl_target):
    traj = _transition(_trajectory(6, 8, 16, OBS_DIM, NUM_ACTIONS))
    _, _, learner, params, opt_states = _setup(
        ["system.adaptive_kl_beta=true", f"system.kl_target={kl_target}"],
        policy_loss_fn=_kl_penalty_loss)
    beta = torch.tensor(3.0)
    result = learner.update(params, opt_states, traj, permutations=_perms(2, 128), kl_beta=beta)
    measured = result.loss_info["measured_kl"]
    with torch.no_grad():
        new = learner.actor_apply(result.params.actor_params, traj.obs)
        old = learner.actor_apply(params.actor_params, traj.obs)
        torch.testing.assert_close(measured, old.kl_divergence(new).mean(), rtol=0, atol=0)
    assert float(measured) > 0
    assert torch.equal(result.kl_beta, ff_ppo.adapt_kl_beta(beta, measured, kl_target))
    assert float(result.kl_beta) == (6.0 if kl_target < 1 else 1.5)
    assert torch.equal(result.loss_info["kl_beta"], result.kl_beta)


# ------------------------------------------------------------------ normalisation


def test_normalize_observations_update_step_matches_jax():
    _, _, learner, params, opt_states = _setup(["system.normalize_observations=true"])
    raw = _trajectory(7, 8, 16, OBS_DIM, NUM_ACTIONS)
    traj = _transition(raw)
    prior = np.random.default_rng(8).normal(size=(5, OBS_DIM)).astype(np.float32) * 3 + 1
    stats = rs.update(rs.init_state(t(np.zeros(OBS_DIM, np.float32))), t(prior))
    jstats = jrs.update(jrs.init_state(jnp.zeros(OBS_DIM, jnp.float32)), jnp.asarray(prior))
    state = ff_ppo.PPOLearnerState(params, opt_states, torch.Generator().manual_seed(0), None,
                                   None, stats, torch.tensor(3.0))
    learner.rollout = lambda s: (s, traj)
    seen = {}
    update = learner.update

    def capture(p, o, batch, generator, kl_beta=None):
        seen["batch"] = batch
        return update(p, o, batch, generator, permutations=_perms(2, 128), kl_beta=kl_beta)

    learner.update = capture
    new_state, _ = learner.update_step(state)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(n(got), want, rtol=4e-6, atol=4e-6 * np.abs(want).max())

    for field in ("obs", "next_obs"):
        close(getattr(seen["batch"], field).agent_view,
              jrs.normalize(jnp.asarray(raw[field]["agent_view"]), jstats, 10.0))
    want = jrs.update(jstats, jnp.asarray(raw["obs"]["agent_view"]), std_min_value=5e-4,
                      std_max_value=5e4)
    for name in ("count", "mean", "summed_variance", "std"):
        close(getattr(new_state.obs_stats, name), getattr(want, name))


# ------------------------------------------------------------------ update batch


def _jax_update_batch(ja, jap, jc, jcp, traj, permutations, cfg, update_batch):
    """ff_ppo.py:345-400 under jax.vmap(axis_name="batch"): each replica's
    GAE standardised over its own columns, its own permutations, gradients
    pmean'ed over "batch" before the clip and Adam."""
    from stoix_tpu.envs.types import Observation

    s = cfg.system
    width = traj["reward"].shape[1] // update_batch
    cols = lambda x, u: np.asarray(x)[:, u * width:(u + 1) * width]  # noqa: E731
    replicas = []
    for u in range(update_batch):
        obs = Observation(*(jnp.asarray(cols(traj["obs"][k], u)) for k in Observation._fields))
        nxt = Observation(*(jnp.asarray(cols(traj["next_obs"][k], u))
                            for k in Observation._fields))
        adv, tgt = jax_gae(
            jnp.asarray(cols(traj["reward"], u)),
            s.gamma * (1.0 - jnp.asarray(cols(traj["done"], u)).astype(jnp.float32)),
            s.gae_lambda, v_tm1=jnp.asarray(cols(traj["value"], u)), v_t=jc.apply(jcp, nxt),
            truncation_t=jnp.asarray(cols(traj["truncated"], u)).astype(jnp.float32),
            standardize_advantages=True, impl="scan",
        )
        replicas.append(jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), (
            obs, jnp.asarray(cols(traj["action"], u)), jnp.asarray(cols(traj["log_prob"], u)),
            jnp.asarray(cols(traj["value"], u)), adv, tgt)))

    def actor_loss(params, obs, action, old_log_prob, gae):
        dist = ja.apply(params, obs)
        loss_actor = jlosses.ppo_clip_loss(dist.log_prob(action), old_log_prob, gae, s.clip_eps)
        entropy = dist.entropy().mean()
        return loss_actor - s.ent_coef * entropy, (loss_actor, entropy)

    def critic_loss(params, obs, targets, old_value):
        value_loss = jlosses.clipped_value_loss(jc.apply(params, obs), old_value, targets,
                                                s.clip_eps)
        return s.vf_coef * value_loss, value_loss

    make_optim = lambda: optax.chain(optax.clip_by_global_norm(float(s.max_grad_norm)),  # noqa
                                     optax.adam(float(s.actor_lr), eps=1e-5))
    actor_optim, critic_optim = make_optim(), make_optim()

    def minibatch(ap, cp, a_state, c_state, mb):
        obs, action, log_prob, value, adv, tgt = mb
        a_grads, (loss_actor, entropy) = jax.grad(actor_loss, has_aux=True)(
            ap, obs, action, log_prob, adv)
        c_grads, value_loss = jax.grad(critic_loss, has_aux=True)(cp, obs, tgt, value)
        a_grads = jax.lax.pmean(a_grads, axis_name="batch")
        c_grads = jax.lax.pmean(c_grads, axis_name="batch")
        updates, a_state = actor_optim.update(a_grads, a_state)
        ap = optax.apply_updates(ap, updates)
        updates, c_state = critic_optim.update(c_grads, c_state)
        cp = optax.apply_updates(cp, updates)
        return ap, cp, a_state, c_state, jnp.stack([loss_actor, value_loss, entropy])

    step = jax.jit(jax.vmap(minibatch, axis_name="batch"))
    stack = lambda tree: jax.tree.map(lambda x: jnp.stack([x] * update_batch), tree)  # noqa
    ap, cp = stack(jap), stack(jcp)
    a_state, c_state = stack(actor_optim.init(jap)), stack(critic_optim.init(jcp))
    losses = []
    for per_replica in permutations:
        mbs = [jax.tree.map(lambda x: jnp.take(x, jnp.asarray(p.numpy()), axis=0).reshape(
            (s.num_minibatches, -1) + x.shape[1:]), flat) for p, flat in zip(per_replica, replicas)]
        for i in range(s.num_minibatches):
            mb = jax.tree.map(lambda *xs: jnp.stack([x[i] for x in xs]), *mbs)
            ap, cp, a_state, c_state, loss = step(ap, cp, a_state, c_state, mb)
            losses.append(np.asarray(loss))
    return ap, cp, np.stack(losses)  # losses [steps, U, 3]


def test_update_batch_step_matches_jax_vmapped_composition(monkeypatch):
    update_batch, t_len, n_envs = 2, 8, 32
    cfg, (ja, jap, jc, jcp), learner, params, opt_states = _setup(
        [f"arch.update_batch_size={update_batch}"])
    raw = _trajectory(9, t_len, n_envs, OBS_DIM, NUM_ACTIONS)
    perms = [[torch.from_numpy(np.random.default_rng(20 + 2 * e + u).permutation(
        t_len * n_envs // update_batch)) for u in range(update_batch)] for e in range(2)]
    want_ap, want_cp, want_losses = _jax_update_batch(ja, jap, jc, jcp, raw, perms, cfg,
                                                      update_batch)
    calls = {"gae": 0}
    gae = ff_ppo.truncated_generalized_advantage_estimation

    def counted(*args, **kwargs):
        calls["gae"] += 1
        return gae(*args, **kwargs)

    monkeypatch.setattr(ff_ppo, "truncated_generalized_advantage_estimation", counted)
    result = learner.update(tree_stack([params] * update_batch),
                            tree_stack([opt_states] * update_batch), _transition(raw),
                            permutations=perms)
    assert calls["gae"] == 1  # the [T, U·E] trajectory in one call: one B1 launch on the card
    got_losses = np.stack([n(result.loss_info[k]) for k in ("actor_loss", "value_loss",
                                                             "entropy")], -1)
    np.testing.assert_allclose(got_losses.reshape(want_losses.shape), want_losses, rtol=1e-5,
                               atol=1e-7)
    for u in range(update_batch):
        for got, want in ((result.params.actor_params, want_ap),
                          (result.params.critic_params, want_cp)):
            replica_u = {k: v[u] for k, v in got.items()}
            want_u = jax.tree.map(lambda x: x[u], want)
            jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                                                 atol=1e-5),
                         to_flax_params(replica_u, want_u), want_u)
    for side in result.params:  # the replicas stay identical
        for v in side.values():
            assert torch.equal(v[0], v[1])


def test_every_knob_learns_identity_game():
    overrides = IDENTITY_OVERRIDES + [
        "system.normalize_observations=true", "system.update_guard=skip",
        "system.fused_update=true", "arch.update_batch_size=2",
        "env.wrapper.use_cached_auto_reset=true",
    ]
    assert ff_ppo.run_experiment(make_config(overrides), device="cpu") > 8.0
