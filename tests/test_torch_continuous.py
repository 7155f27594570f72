"""The continuous and penalty PPO family of the PyTorch port against the JAX
package: the six continuous distributions, `ppo_penalty_loss`, `dpo_loss`
and the penalty and DPO policy losses with their gradients, the KL branch
each head takes, and one update step of ff_ppo_continuous (also at
`update_batch_size` 2), ff_ppo_penalty, ff_ppo_penalty_continuous and
ff_dpo_continuous against JAX's composition on explicit inputs.

Random streams differ between `jax.random` and `torch.Generator`, so every
draw is held at op level: the Gaussians take the same standard-normal noise
in both packages, and the Beta's draws are checked by their moments.

Tolerances (float32): distributions 1e-5 relative, with an absolute floor of
1e-5 of each output's largest entry (the Beta's log-density is a difference
of lgamma terms, whose ulps XLA and PyTorch round differently);
losses 1e-5 relative and their gradients 1e-5 of the largest entry (of the
loss's input, or of any of the head's parameters); update steps: losses 1e-5 relative, params 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu.ops import distributions as jd
from stoix_tpu.ops import losses as jlosses
from stoix_tpu.ops.multistep import truncated_generalized_advantage_estimation as jax_gae
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams, PPOTransition
from stoix_tpu_torch.envs.types import Observation as TorchObservation
from stoix_tpu_torch.kernels import linear_recurrence
from stoix_tpu_torch.ops import distributions as td
from stoix_tpu_torch.ops import losses as tlosses
from stoix_tpu_torch.systems.ppo.anakin import (
    ff_dpo_continuous,
    ff_ppo,
    ff_ppo_continuous,
    ff_ppo_penalty,
    ff_ppo_penalty_continuous,
)
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.tree import tree_stack
from torch_parity import n, t, to_flax_params

def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(np.abs(want).max(), 0.1))
HEADS = ("NormalAffineTanhDistributionHead", "BetaDistributionHead",
         "MultivariateNormalDiagHead")


# ------------------------------------------------------------------ distributions


def _gaussian_params(seed, shape, loc_scale=1.0):
    rng = np.random.default_rng(seed)
    loc = (rng.normal(size=shape) * loc_scale).astype(np.float32)
    scale = rng.uniform(0.2, 1.5, size=shape).astype(np.float32)
    return loc, scale


def _pair(kind, seed=0):
    """(jax distribution, port distribution, a value inside the support)."""
    shape = (6, 3)
    rng = np.random.default_rng(seed + 100)
    if kind in ("normal", "mvn"):
        loc, scale = _gaussian_params(seed, shape)
        value = rng.normal(size=shape).astype(np.float32)
        if kind == "normal":
            return jd.Normal(jnp.asarray(loc), jnp.asarray(scale)), td.Normal(t(loc), t(scale)), value
        return (jd.MultivariateNormalDiag(jnp.asarray(loc), jnp.asarray(scale)),
                td.MultivariateNormalDiag(t(loc), t(scale)), value)
    if kind.startswith("tanh"):
        loc, scale = _gaussian_params(seed, shape)
        lo, hi = ([-2.0, -1.0, 0.0], [2.0, 3.0, 0.5]) if kind == "tanh_bounds" else (-2.0, 2.0)
        mid, half = (np.asarray(hi) + np.asarray(lo)) / 2, (np.asarray(hi) - np.asarray(lo)) / 2
        value = (mid + half * np.tanh(rng.normal(size=shape))).astype(np.float32)
        # Actions at and past the clip threshold, and at the bounds.
        value[0] = (mid + half * np.array([0.9995, -1.0, 1.0]))
        return (jd.Independent(jd.TanhNormal(jnp.asarray(loc), jnp.asarray(scale), jnp.asarray(lo),
                                             jnp.asarray(hi)), 1),
                td.Independent(td.TanhNormal(t(loc), t(scale), lo, hi), 1), value)
    rng_ab = np.random.default_rng(seed)
    alpha = rng_ab.uniform(0.5, 4.0, size=shape).astype(np.float32)
    beta = rng_ab.uniform(0.5, 4.0, size=shape).astype(np.float32)
    alpha[0, 0], beta[0, 0] = 0.7, 0.6  # mode at the edges
    alpha[0, 1], beta[0, 1] = 2.0, 2.0
    if kind == "beta":
        value = rng.uniform(0.01, 0.99, size=shape).astype(np.float32)
        return jd.Beta(jnp.asarray(alpha), jnp.asarray(beta)), td.Beta(t(alpha), t(beta)), value
    value = rng.uniform(-1.9, 1.9, size=shape).astype(np.float32)
    return (jd.AffineBeta(jnp.asarray(alpha), jnp.asarray(beta), -2.0, 2.0),
            td.AffineBeta(t(alpha), t(beta), -2.0, 2.0), value)


KINDS = ("normal", "mvn", "tanh", "tanh_bounds", "beta", "affine_beta")


def _same_or_both_raise(jax_fn, torch_fn, exc):
    try:
        want = np.asarray(jax_fn())
    except exc:
        with pytest.raises(exc):
            torch_fn()
        return None
    got = n(torch_fn())
    np.testing.assert_allclose(got, want)
    return got


@pytest.mark.parametrize("kind", KINDS)
def test_distribution_matches_jax(kind):
    jdist, tdist, value = _pair(kind)
    assert_close(n(tdist.log_prob(t(value))),
                               np.asarray(jdist.log_prob(jnp.asarray(value))))
    for method in ("entropy", "mode", "mean"):
        assert_close(n(getattr(tdist, method)()),
                                   np.asarray(getattr(jdist, method)()))
    # stddev only where the JAX class has it (the Gaussians); elsewhere both raise.
    _same_or_both_raise(lambda: jdist.stddev(), lambda: tdist.stddev(), AttributeError)
    jother, tother, _ = _pair(kind, seed=1)
    kl = _same_or_both_raise(lambda: jdist.kl_divergence(jother),
                             lambda: tdist.kl_divergence(tother), NotImplementedError)
    assert (kl is None) == (kind not in ("normal", "mvn"))


@pytest.mark.parametrize("kind", ["normal", "mvn", "tanh", "tanh_bounds"])
def test_gaussian_sample_and_log_prob_from_the_same_noise(kind):
    jdist, tdist, _ = _pair(kind)
    key = jax.random.PRNGKey(7)
    want_x, want_lp = jdist.sample_and_log_prob(seed=key)
    noise = np.asarray(jax.random.normal(key, (6, 3), jnp.float32))
    got_x, got_lp = tdist.sample_and_log_prob(noise=t(noise))
    assert_close(n(got_x), np.asarray(want_x))
    assert_close(n(got_lp), np.asarray(want_lp))
    assert_close(n(tdist.sample(noise=t(noise))),
                               np.asarray(jdist.sample(seed=key)))


def test_tanh_normal_keeps_the_reference_semantics_past_the_bound_and_at_large_x():
    """log_prob clips the inverse at 0.999, so a draw past it does not get
    back its own density; the log-det uses softplus(-2x) = logaddexp(-2x, 0)
    at |x| > 20 (F.softplus would switch to the identity there); entropy is
    the base entropy plus the log-det at loc."""
    loc = np.array([[25.0, -25.0, 0.0, 21.0, -30.0]], np.float32)
    scale = np.array([[0.5, 0.5, 0.5, 2.0, 0.1]], np.float32)
    noise = np.array([[0.0, 0.0, 4.0, 1.0, -1.0]], np.float32)
    jdist = jd.TanhNormal(jnp.asarray(loc), jnp.asarray(scale), -2.0, 2.0)
    tdist = td.TanhNormal(t(loc), t(scale), -2.0, 2.0)
    assert_close(n(tdist.entropy()), np.asarray(jdist.entropy()))
    x = loc + scale * noise
    want_lp = jdist.base.log_prob(jnp.asarray(x)) - jdist._log_det_jacobian(jnp.asarray(x))
    got_x, got_lp = tdist.sample_and_log_prob(noise=t(noise))
    assert_close(n(got_lp), np.asarray(want_lp))
    # The stored action re-scored: clipped, so not the sampled density.
    rescored = n(tdist.log_prob(got_x))
    assert_close(rescored, np.asarray(jdist.log_prob(jnp.asarray(n(got_x)))))
    assert not np.allclose(rescored[0, :2], n(got_lp)[0, :2])
    np.testing.assert_array_equal(n(td.softplus(torch.tensor([30.0, -30.0]))),
                                  np.asarray(jax.nn.softplus(jnp.asarray([30.0, -30.0]))))


def test_affine_beta_sample_and_log_prob_is_the_inner_betas_as_in_the_reference():
    """ROADMAP C13: AffineBeta inherits Independent's sample_and_log_prob,
    which returns the inner Beta's draw on [0, 1] and its log-prob,
    unscaled, in both packages."""
    jdist, tdist, _ = _pair("affine_beta")
    jx, jlp = jdist.sample_and_log_prob(seed=jax.random.PRNGKey(3))
    assert float(jnp.min(jx)) >= 0.0 and float(jnp.max(jx)) <= 1.0
    assert_close(np.asarray(jlp), jdist._base.log_prob(jx).sum(-1))
    x, lp = tdist.sample_and_log_prob(torch.Generator().manual_seed(3))
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert_close(n(lp), jdist._base.log_prob(jnp.asarray(n(x))).sum(-1))


def test_beta_draws_have_the_right_moments_and_repeat_from_a_seed():
    alpha = torch.tensor([0.7, 2.0, 5.0, 1.5])
    beta = torch.tensor([0.6, 2.0, 1.2, 8.0])
    count = 200_000
    dist = td.AffineBeta(alpha.expand(count, 4), beta.expand(count, 4), -2.0, 2.0)
    draws = dist.sample(torch.Generator().manual_seed(0))
    again = dist.sample(torch.Generator().manual_seed(0))
    assert torch.equal(draws, again)
    unit = (draws.double() + 2.0) / 4.0
    mean = alpha.double() / (alpha + beta).double()
    var = mean * (1 - mean) / (alpha + beta + 1).double()
    # Five standard errors of the mean and of the variance.
    np.testing.assert_array_less(np.abs(n(unit.mean(0) - mean)), n(5 * (var / count).sqrt()))
    np.testing.assert_allclose(n(unit.var(0)), n(var), rtol=0.02)
    assert float(draws.min()) >= -2.0 and float(draws.max()) <= 2.0


def test_normal_draws_come_from_the_generator():
    dist = td.Normal(torch.zeros(100_000), torch.full((100_000,), 2.0))
    a = dist.sample(torch.Generator().manual_seed(1))
    assert torch.equal(a, dist.sample(torch.Generator().manual_seed(1)))
    assert abs(float(a.mean())) < 5 * 2.0 / np.sqrt(1e5)
    assert abs(float(a.std()) - 2.0) < 0.02


# ------------------------------------------------------------------ losses


def _loss_inputs(seed, batch=64):
    rng = np.random.default_rng(seed)
    log_prob = rng.normal(scale=0.3, size=batch).astype(np.float32)
    old = rng.normal(scale=0.3, size=batch).astype(np.float32)
    old[:2] = log_prob[:2] + np.array([30.0, -30.0], np.float32)  # the clamp at +-20
    adv = rng.normal(size=batch).astype(np.float32)
    adv[2] = 0.0
    kl = rng.uniform(0.0, 0.1, size=batch).astype(np.float32)
    return log_prob, old, adv, kl


def _assert_grads(tgrad, jgrad):
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(n(tgrad), jgrad, rtol=0, atol=1e-5 * np.abs(jgrad).max())


@pytest.mark.parametrize("beta", [0.5, 3.0])
def test_ppo_penalty_loss_and_grad_match_jax(beta):
    log_prob, old, adv, kl = _loss_inputs(0)
    fn = lambda lp, k: jlosses.ppo_penalty_loss(lp, jnp.asarray(old), jnp.asarray(adv), beta, k)
    want, (g_lp, g_kl) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(log_prob),
                                                                 jnp.asarray(kl))
    lp_t, kl_t = t(log_prob).requires_grad_(True), t(kl).requires_grad_(True)
    got = tlosses.ppo_penalty_loss(lp_t, t(old), t(adv), torch.tensor(beta), kl_t)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _assert_grads(lp_t.grad, g_lp)
    _assert_grads(kl_t.grad, g_kl)


@pytest.mark.parametrize("alpha,beta", [(2.0, 0.6), (0.5, 0.1)])
def test_dpo_loss_and_grad_match_jax(alpha, beta):
    log_prob, old, adv, _ = _loss_inputs(1)
    fn = lambda lp: jlosses.dpo_loss(lp, jnp.asarray(old), jnp.asarray(adv), alpha, beta)
    want, g_lp = jax.value_and_grad(fn)(jnp.asarray(log_prob))
    lp_t = t(log_prob).requires_grad_(True)
    got = tlosses.dpo_loss(lp_t, t(old), t(adv), alpha, beta)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _assert_grads(lp_t.grad, g_lp)


def _flax_head(name, action_dim, seed, **kwargs):
    from stoix_tpu.networks import heads as jheads
    from stoix_tpu_torch.networks import heads as theads

    jhead = getattr(jheads, name)(action_dim, **kwargs)
    params = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8))))
    thead = getattr(theads, name)(action_dim, 8, **kwargs)
    load_flax_params(thead, params)
    return jhead, params, thead


def _policy_loss_inputs(kind, seed):
    """A head's (jax head, params, port head, actions, old log-probs,
    advantages, behaviour params, embeddings) for one policy-loss check."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(32, 8)).astype(np.float32)
    if kind == "CategoricalHead":
        jhead, params, thead = _flax_head(kind, 4, seed)
        action = rng.integers(0, 4, size=32).astype(np.int32)
    else:
        kwargs = {} if kind == "MultivariateNormalDiagHead" else dict(minimum=-2.0, maximum=2.0)
        jhead, params, thead = _flax_head(kind, 2, seed, **kwargs)
        action = rng.uniform(-1.9, 1.9, size=(32, 2)).astype(np.float32)
    # Sharpen the weights so the policies are not near-uniform.
    params = jax.tree.map(lambda x: x * 40.0, params)
    behaviour = jax.tree.map(lambda x: x * 0.9, params)
    load_flax_params(thead, params)
    old = np.asarray(jhead.apply(behaviour, jnp.asarray(emb)).log_prob(jnp.asarray(action)))
    adv = rng.normal(size=32).astype(np.float32)
    return jhead, params, thead, action, old, adv, behaviour, emb


def _jax_policy_loss(kind, loss_fn, cfg, jhead, behaviour, emb, action, old, adv):
    from stoix_tpu.systems.ppo.anakin.ff_dpo_continuous import dpo_policy_loss
    from stoix_tpu.systems.ppo.anakin.ff_ppo_penalty import penalty_policy_loss

    jfn = penalty_policy_loss if loss_fn == "penalty" else dpo_policy_loss

    def loss(p):
        dist = jhead.apply(p, jnp.asarray(emb))
        bdist = jhead.apply(behaviour, jnp.asarray(emb))
        return jfn(dist, jnp.asarray(action), jnp.asarray(old), jnp.asarray(adv), cfg,
                   behavior_dist=bdist, beta=jnp.asarray(2.0))

    return loss


@pytest.mark.parametrize("kind", ["CategoricalHead", *HEADS])
@pytest.mark.parametrize("loss_fn", ["penalty", "dpo"])
def test_policy_losses_and_grads_match_jax_for_each_head(kind, loss_fn):
    """The penalty loss takes the analytic KL for Categorical and the
    diagonal Gaussian and the k3 estimator for TanhNormal and Beta, where
    `kl_divergence` raises, in both packages; the DPO loss reads neither."""
    cfg = jax_config.compose(jax_config.default_config_dir(),
                             "default/anakin/default_ff_dpo_continuous.yaml")
    jhead, params, thead, action, old, adv, behaviour, emb = _policy_loss_inputs(kind, 0)
    loss = _jax_policy_loss(kind, loss_fn, cfg, jhead, behaviour, emb, action, old, adv)
    (want, want_entropy), grads = jax.value_and_grad(loss, has_aux=True)(params)

    torch_fn = (ff_ppo_penalty.penalty_policy_loss if loss_fn == "penalty"
                else ff_dpo_continuous.dpo_policy_loss)
    with torch.no_grad():
        bhead = type(thead)(*([4] if kind == "CategoricalHead" else [2]), 8,
                            **({} if kind in ("CategoricalHead", "MultivariateNormalDiagHead")
                               else dict(minimum=-2.0, maximum=2.0)))
        load_flax_params(bhead, behaviour)
        bdist = bhead(t(emb))
    got, entropy = torch_fn(thead(t(emb)), t(action), t(old), t(adv),
                            config_lib.compose(config_lib.default_config_dir(),
                                               "default/anakin/default_ff_dpo_continuous.yaml"),
                            behavior_dist=bdist, beta=torch.tensor(2.0))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(entropy.detach()), float(want_entropy), rtol=1e-5, atol=1e-6)
    got_grads = to_flax_params({k: v.grad for k, v in thead.named_parameters()}, params)
    largest = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(grads))
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                                         atol=1e-5 * largest), got_grads, grads)

    analytic = kind in ("CategoricalHead", "MultivariateNormalDiagHead")
    if analytic:
        bdist.kl_divergence(thead(t(emb)))
    else:
        with pytest.raises(NotImplementedError):
            bdist.kl_divergence(thead(t(emb)))


def test_penalty_loss_marks_kl_beta_and_dpo_does_not():
    assert ff_ppo_penalty.penalty_policy_loss.uses_kl_beta is True
    assert not getattr(ff_dpo_continuous.dpo_policy_loss, "uses_kl_beta", False)
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             "default/anakin/default_ff_dpo_continuous.yaml",
                             ["system.adaptive_kl_beta=true", "arch.total_num_envs=8",
                              "arch.num_updates=1", "arch.num_evaluation=1"])
    with pytest.raises(ValueError, match="adaptive_kl_beta"):
        ff_dpo_continuous.run_experiment(cfg, device="cpu")


# ------------------------------------------------------------------ update steps

ROOTS = {
    "ff_ppo_continuous": "default/anakin/default_ff_ppo_continuous.yaml",
    "ff_ppo_penalty": "default/anakin/default_ff_ppo_penalty.yaml",
    "ff_ppo_penalty_continuous": "default/anakin/default_ff_ppo_penalty_continuous.yaml",
    "ff_dpo_continuous": "default/anakin/default_ff_dpo_continuous.yaml",
}
SYSTEMS = {"ff_ppo_continuous": ff_ppo_continuous, "ff_ppo_penalty": ff_ppo_penalty,
           "ff_ppo_penalty_continuous": ff_ppo_penalty_continuous,
           "ff_dpo_continuous": ff_dpo_continuous}


def _paired_actor_critic(discrete, obs_dim, action_dim, seed, head="NormalAffineTanhDistributionHead"):
    """flax and port actor/critic pairs with identical params (MLP 16 x 16)."""
    from stoix_tpu.networks import base as jbase, heads as jheads, inputs as jinputs
    from stoix_tpu.networks import torso as jtorso
    from stoix_tpu_torch.networks import base as tbase, heads as theads, inputs as tinputs
    from stoix_tpu_torch.networks import torso as ttorso
    from torch_parity import observations

    if discrete:
        jh, th = jheads.CategoricalHead(action_dim), theads.CategoricalHead(action_dim, 16)
    else:
        kwargs = {} if head == "MultivariateNormalDiagHead" else dict(minimum=-2.0, maximum=2.0)
        jh = getattr(jheads, head)(action_dim, **kwargs)
        th = getattr(theads, head)(action_dim, 16, **kwargs)
    ja = jbase.FeedForwardActor(action_head=jh, torso=jtorso.MLPTorso((16, 16)),
                                input_layer=jinputs.ObservationInput())
    jc = jbase.FeedForwardCritic(critic_head=jheads.ScalarCriticHead(),
                                 torso=jtorso.MLPTorso((16, 16)),
                                 input_layer=jinputs.ObservationInput())
    dummy, _ = observations(0, 1, obs_dim, 1 if not discrete else action_dim)
    ka, kc = jax.random.split(jax.random.PRNGKey(seed))
    jap = jax.tree.map(np.asarray, ja.init(ka, dummy))
    jcp = jax.tree.map(np.asarray, jc.init(kc, dummy))
    ta = tbase.FeedForwardActor(th, ttorso.MLPTorso(obs_dim, (16, 16)), tinputs.ObservationInput())
    tc = tbase.FeedForwardCritic(theads.ScalarCriticHead(16), ttorso.MLPTorso(obs_dim, (16, 16)),
                                 tinputs.ObservationInput())
    load_flax_params(ta, jap)
    load_flax_params(tc, jcp)
    return ja, jap, jc, jcp, ta, tc


def _trajectory(seed, t_len, n_envs, obs_dim, action_dim, discrete, ja, jap):
    """A [T, E] trajectory whose log-probs are the actor's own on its actions."""
    from stoix_tpu.envs.types import Observation

    rng = np.random.default_rng(seed)

    def obs():
        return {"agent_view": rng.normal(size=(t_len, n_envs, obs_dim)).astype(np.float32),
                "action_mask": np.ones((t_len, n_envs, action_dim if discrete else 1), np.float32),
                "step_count": np.zeros((t_len, n_envs), np.int32)}

    traj = {"obs": obs(), "next_obs": obs()}
    if discrete:
        traj["action"] = rng.integers(0, action_dim, size=(t_len, n_envs)).astype(np.int32)
    else:
        traj["action"] = rng.uniform(-1.9, 1.9, size=(t_len, n_envs, action_dim)).astype(np.float32)
    jobs = Observation(*(jnp.asarray(traj["obs"][k]) for k in Observation._fields))
    traj["log_prob"] = np.asarray(ja.apply(jap, jobs).log_prob(jnp.asarray(traj["action"])))
    done = rng.uniform(size=(t_len, n_envs)) < 0.1
    traj.update(reward=rng.normal(size=(t_len, n_envs)).astype(np.float32),
                value=rng.normal(size=(t_len, n_envs)).astype(np.float32), done=done,
                truncated=(rng.uniform(size=(t_len, n_envs)) < 0.1) & ~done)
    return traj


def _jax_update(ja, jap, jc, jcp, traj, perms, cfg, policy_loss_fn, update_batch):
    """JAX ff_ppo.py's _update_step after the rollout (:295-345) with the
    learner's own losses and optax chain, under `jax.vmap(axis_name="batch")`
    over U replicas (each its [T, E] columns and its own permutations, the
    gradients pmeaned). Returns advantages [U, T, E], losses [steps, U, 3]
    and the (actor, critic) params, which stay identical across replicas."""
    from stoix_tpu.envs.types import Observation

    s = cfg.system
    make_optim = lambda lr: optax.chain(optax.clip_by_global_norm(float(s.max_grad_norm)),
                                        optax.adam(lr, eps=1e-5))
    aopt, copt = make_optim(float(s.actor_lr)), make_optim(float(s.critic_lr))
    beta = jnp.asarray(float(s.get("kl_beta", 3.0)))

    def split(x):  # [T, U.E, ...] -> [U, T, E, ...]
        x = jnp.asarray(x)
        return jnp.moveaxis(x.reshape(x.shape[:1] + (update_batch, -1) + x.shape[2:]), 1, 0)

    def prepare(tr):
        obs = Observation(*(tr["obs"][k] for k in Observation._fields))
        next_obs = Observation(*(tr["next_obs"][k] for k in Observation._fields))
        advantages, targets = jax_gae(
            tr["reward"] * float(s.get("reward_scale", 1.0)),
            s.gamma * (1.0 - tr["done"].astype(jnp.float32)), s.gae_lambda,
            v_tm1=tr["value"], v_t=jc.apply(jcp, next_obs),
            truncation_t=tr["truncated"].astype(jnp.float32),
            standardize_advantages=True, impl="scan")
        flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]),
                            (obs, tr["action"], tr["log_prob"], tr["value"], advantages, targets))
        return flat, advantages

    def actor_loss(p, o, a, olp, gae):
        dist = ja.apply(p, o)
        if policy_loss_fn is None:
            loss = jlosses.ppo_clip_loss(dist.log_prob(a), olp, gae, s.clip_eps)
            entropy = dist.entropy().mean()
        else:  # the behaviour policy: the rollout's params on the same observations
            loss, entropy = policy_loss_fn(dist, a, olp, gae, cfg,
                                           behavior_dist=ja.apply(jap, o), beta=beta)
        return loss - s.ent_coef * entropy, (loss, entropy)

    def critic_loss(p, o, tgt, old_v):
        vl = jlosses.clipped_value_loss(jc.apply(p, o), old_v, tgt, s.clip_eps)
        return s.vf_coef * vl, vl

    def minibatch(params, states, batch):
        o, a, olp, v, g, tg = batch
        ag, (la, ent) = jax.grad(actor_loss, has_aux=True)(params[0], o, a, olp, g)
        cg, vl = jax.grad(critic_loss, has_aux=True)(params[1], o, tg, v)
        ag, cg = jax.lax.pmean((ag, cg), "batch")
        au, a_s = aopt.update(ag, states[0])
        cu, c_s = copt.update(cg, states[1])
        return ((optax.apply_updates(params[0], au), optax.apply_updates(params[1], cu)),
                (a_s, c_s), jnp.stack([la, vl, ent]))

    trajs = jax.tree.map(split, traj)
    flat, advantages = jax.vmap(prepare)(trajs)
    step = jax.jit(jax.vmap(minibatch, axis_name="batch", in_axes=(None, None, 0)))
    params, states, losses = (jap, jcp), (aopt.init(jap), copt.init(jcp)), []
    for epoch_perms in perms:
        mbs = [jax.tree.map(lambda x: jnp.take(x[u], jnp.asarray(epoch_perms[u]), axis=0).reshape(
            (s.num_minibatches, -1) + x.shape[2:]), flat) for u in range(update_batch)]
        for i in range(s.num_minibatches):
            batch = jax.tree.map(lambda *xs: jnp.stack([x[i] for x in xs]), *mbs)
            new_params, new_states, loss = step(params, states, batch)
            params = jax.tree.map(lambda x: x[0], new_params)
            states = jax.tree.map(lambda x: x[0], new_states)
            losses.append(np.asarray(loss))
    return np.asarray(advantages), np.stack(losses), params


CASES = [  # (system, discrete, head, update_batch)
    ("ff_ppo_continuous", False, "NormalAffineTanhDistributionHead", 1),
    ("ff_ppo_continuous", False, "NormalAffineTanhDistributionHead", 2),
    ("ff_ppo_penalty", True, None, 1),
    ("ff_ppo_penalty_continuous", False, "NormalAffineTanhDistributionHead", 1),
    ("ff_ppo_penalty_continuous", False, "MultivariateNormalDiagHead", 1),
    ("ff_dpo_continuous", False, "BetaDistributionHead", 1),
]


@pytest.mark.parametrize("system,discrete,head,update_batch", CASES)
def test_one_update_step_matches_jax_composition(system, discrete, head, update_batch):
    from stoix_tpu.systems.ppo.anakin.ff_dpo_continuous import dpo_policy_loss
    from stoix_tpu.systems.ppo.anakin.ff_ppo_penalty import penalty_policy_loss

    overrides = ["system.epochs=2", "system.num_minibatches=2", "system.actor_lr=1.0e-3",
                 "system.critic_lr=1.0e-3", f"arch.update_batch_size={update_batch}",
                 "arch.num_updates_per_eval=1"]
    root = ROOTS[system]
    cfg = config_lib.compose(config_lib.default_config_dir(), root, overrides)
    jcfg = jax_config.compose(jax_config.default_config_dir(), root, overrides)
    t_len, n_envs, obs_dim, action_dim = 4, 8 * update_batch, 5, 3 if discrete else 2
    ja, jap, jc, jcp, ta, tc = _paired_actor_critic(discrete, obs_dim, action_dim, 3, head)
    traj = _trajectory(0, t_len, n_envs, obs_dim, action_dim, discrete, ja, jap)
    per = t_len * n_envs // update_batch
    perms = [[np.random.default_rng(10 + 2 * e + u).permutation(per) for u in range(update_batch)]
             for e in range(2)]
    jloss = {"ff_ppo_continuous": None, "ff_dpo_continuous": dpo_policy_loss}.get(
        system, penalty_policy_loss)
    want_adv, want_losses, (want_ap, want_cp) = _jax_update(
        ja, jap, jc, jcp, traj, perms, jcfg, jloss, update_batch)

    loss_fn = {"ff_ppo_continuous": None, "ff_ppo_penalty": ff_ppo_penalty.penalty_policy_loss,
               "ff_ppo_penalty_continuous": ff_ppo_penalty.penalty_policy_loss,
               "ff_dpo_continuous": ff_dpo_continuous.dpo_policy_loss}[system]
    params = ActorCriticParams({k: v.detach() for k, v in ta.named_parameters()},
                               {k: v.detach() for k, v in tc.named_parameters()})
    optims = ff_ppo.make_optimizers(cfg)
    opt = ActorCriticOptStates(optims[0].init(params.actor_params),
                               optims[1].init(params.critic_params))
    if update_batch > 1:
        params, opt = tree_stack([params] * update_batch), tree_stack([opt] * update_batch)
    learner = ff_ppo.get_learner_fn(None, (ff_ppo.make_apply_fn(ta), ff_ppo.make_apply_fn(tc)),
                                    optims, cfg, loss_fn)
    as_obs = lambda o: TorchObservation(*(t(o[k]) for k in TorchObservation._fields))
    transition = PPOTransition(
        done=t(traj["done"]), truncated=t(traj["truncated"]), action=t(traj["action"]),
        value=t(traj["value"]), reward=t(traj["reward"]), log_prob=t(traj["log_prob"]),
        obs=as_obs(traj["obs"]), next_obs=as_obs(traj["next_obs"]), info={})
    given = [torch.from_numpy(p[0]) if update_batch == 1 else [torch.from_numpy(q) for q in p]
             for p in perms]
    result = learner.update(params, opt, transition, permutations=given,
                            kl_beta=torch.tensor(float(cfg.system.get("kl_beta", 3.0))))

    got_adv = n(result.advantages).reshape(t_len, update_batch, -1).transpose(1, 0, 2)
    np.testing.assert_allclose(got_adv, want_adv, rtol=0, atol=1e-6)
    got_losses = np.stack([n(result.loss_info[k]) for k in ("actor_loss", "value_loss",
                                                            "entropy")], axis=-1)
    got_losses = got_losses.reshape((-1,) + ((update_batch,) if update_batch > 1 else ()) + (3,))
    np.testing.assert_allclose(got_losses, want_losses.reshape(got_losses.shape), rtol=1e-5,
                               atol=1e-7)
    for got, want in ((result.params.actor_params, want_ap), (result.params.critic_params, want_cp)):
        got = {k: v[0] if update_batch > 1 else v for k, v in got.items()}
        got_tree = to_flax_params(got, want)
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5),
                     got_tree, want)
    moved = jax.tree.map(lambda g, w0: float(np.abs(g - np.asarray(w0)).max()),
                         to_flax_params({k: v[0] if update_batch > 1 else v
                                         for k, v in result.params.actor_params.items()}, jap),
                         jap)
    assert max(jax.tree.leaves(moved)) > 1e-4


def _count_b1_calls(monkeypatch) -> dict:
    """Count the calls of B1's two wrappers, each one launch on the card (on
    the CPU they run their plain versions)."""
    calls = {"gae": 0, "generic": 0}
    for name, key in (("truncated_gae", "gae"), ("linear_recurrence_reverse", "generic")):
        original = getattr(linear_recurrence, name)

        def counted(*args, _original=original, _key=key, **kwargs):
            calls[_key] += 1
            return _original(*args, **kwargs)

        monkeypatch.setattr(linear_recurrence, name, counted)
    return calls


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_each_system_runs_its_default_config_on_cpu_with_one_gae_launch_an_update(
        system, monkeypatch):
    """Each system at the JAX sweep's budget (tests/test_systems_sweep.py:
    16 envs, T = 8) under `multistep_impl=pallas`: finite, one B1 GAE launch
    an update, no generic launch; float actions [E, 1] reach Pendulum."""
    overrides = ["arch.total_num_envs=16", "arch.total_timesteps=512", "arch.num_evaluation=1",
                 "arch.num_eval_episodes=2", "arch.absolute_metric=False",
                 "system.rollout_length=8", "system.multistep_impl=pallas",
                 "logger.use_console=False"]
    if system == "ff_ppo_penalty":
        overrides += ["env=identity_game", "system.adaptive_kl_beta=true"]
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS[system], overrides)
    calls = _count_b1_calls(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        final_return = SYSTEMS[system].run_experiment(cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(final_return)
    updates = 512 // (16 * 8)
    assert calls == {"gae": updates, "generic": 0}


def test_penalty_learns_identity_game_with_adaptive_beta_on_cpu():
    """tests/test_ff_ppo.py::test_ppo_penalty_adaptive_kl_beta_runs's oracle
    (64 envs, 65 536 steps, adaptive β): above 4.0."""
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS["ff_ppo_penalty"], [
        "env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=65536",
        "arch.num_evaluation=1", "arch.num_eval_episodes=32", "arch.absolute_metric=False",
        "system.rollout_length=16", "system.adaptive_kl_beta=true", "system.kl_target=0.01",
        "logger.use_console=False"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        final_return = ff_ppo_penalty.run_experiment(cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert final_return > 4.0, f"adaptive-KL penalty failed to learn: {final_return}"
