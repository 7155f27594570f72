"""Ops of the PyTorch port against the JAX package: the Categorical
distribution, the PPO losses (values and gradients), and the clip + Adam
optimizer against optax.

Tolerances (float32): distributions and losses 1e-6 absolute (logsumexp and
means reduce in another order); optimizer params 1e-6 absolute — the update
itself is optax's arithmetic op for op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu.ops import distributions as jdist, losses as jlosses
from stoix_tpu.utils.training import make_learning_rate as jax_make_learning_rate
from stoix_tpu_torch.ops import distributions as tdist, losses as tlosses
from stoix_tpu_torch.utils.config import Config
from stoix_tpu_torch.utils.training import (
    ClipAdam,
    apply_updates,
    linear_schedule,
    make_learning_rate,
)
from torch_parity import n, t

ATOL = 1e-6


@pytest.mark.parametrize("masked", [False, True])
def test_categorical_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, 5)).astype(np.float32) * 3
    mask = (rng.uniform(size=(64, 5)) > 0.3).astype(np.float32) if masked else None
    if masked:
        mask[:, 2] = 1.0  # at least one legal action per row
    actions = rng.integers(0, 5, size=64)
    if masked:
        actions = np.where(mask[np.arange(64), actions] > 0, actions, 2)
    jd = jdist.Categorical(jnp.asarray(logits), None if mask is None else jnp.asarray(mask))
    td = tdist.Categorical(t(logits), None if mask is None else t(mask))
    np.testing.assert_allclose(n(td.log_prob(t(actions))),
                               np.asarray(jd.log_prob(jnp.asarray(actions))), atol=ATOL)
    np.testing.assert_allclose(n(td.entropy()), np.asarray(jd.entropy()), atol=ATOL)
    np.testing.assert_array_equal(n(td.mode()), np.asarray(jd.mode()))
    np.testing.assert_allclose(n(td.probs), np.asarray(jd.probs), atol=ATOL)


def test_categorical_sampling_follows_probs_and_mask():
    logits = torch.tensor([[0.0, 1.0, -1.0, 2.0]]).repeat(20000, 1)
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0]).expand(20000, 4)
    dist = tdist.Categorical(logits, mask)
    gen = torch.Generator().manual_seed(0)
    samples = dist.sample(gen)
    freq = np.bincount(n(samples), minlength=4) / 20000
    assert freq[2] == 0.0
    np.testing.assert_allclose(freq, n(dist.probs[0]), atol=0.015)
    # Same generator state -> same samples (explicit generators, no global RNG).
    again = dist.sample(torch.Generator().manual_seed(0))
    assert torch.equal(samples, again)


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    log_prob = rng.normal(size=256).astype(np.float32) * 0.3
    old_log_prob = (log_prob + rng.normal(size=256) * 0.3).astype(np.float32)
    old_log_prob[:3] = log_prob[:3] + 30.0  # exercise the ratio clamp
    advantage = rng.normal(size=256).astype(np.float32)
    pred = rng.normal(size=256).astype(np.float32)
    old_value = (pred + rng.normal(size=256) * 0.5).astype(np.float32)
    targets = rng.normal(size=256).astype(np.float32)
    return log_prob, old_log_prob, advantage, pred, old_value, targets


def test_ppo_clip_loss_and_grad_match_jax():
    log_prob, old_log_prob, advantage, *_ = _loss_inputs(1)
    want, want_grad = jax.value_and_grad(jlosses.ppo_clip_loss)(
        jnp.asarray(log_prob), jnp.asarray(old_log_prob), jnp.asarray(advantage), 0.2
    )
    lp = t(log_prob).requires_grad_(True)
    got = tlosses.ppo_clip_loss(lp, t(old_log_prob), t(advantage), 0.2)
    (got_grad,) = torch.autograd.grad(got, lp)
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    np.testing.assert_allclose(n(got_grad), np.asarray(want_grad), atol=ATOL)
    np.testing.assert_allclose(
        n(tlosses._safe_ratio(t(log_prob), t(old_log_prob))),
        np.asarray(jlosses._safe_ratio(jnp.asarray(log_prob), jnp.asarray(old_log_prob))),
        rtol=1e-6,
    )


def test_clipped_value_loss_and_grad_match_jax():
    *_, pred, old_value, targets = _loss_inputs(2)
    want, want_grad = jax.value_and_grad(jlosses.clipped_value_loss)(
        jnp.asarray(pred), jnp.asarray(old_value), jnp.asarray(targets), 0.2
    )
    p = t(pred).requires_grad_(True)
    got = tlosses.clipped_value_loss(p, t(old_value), t(targets), 0.2)
    (got_grad,) = torch.autograd.grad(got, p)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(n(got_grad), np.asarray(want_grad), atol=ATOL)


def _params_and_grads(seed, grad_scale):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(8, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * grad_scale).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["no_clip", "clip_fires"])
def test_clip_adam_matches_optax(grad_scale):
    params, grads = _params_and_grads(3, grad_scale)
    max_norm, lr = 0.5, 3e-4
    g_norm = np.sqrt(sum((g**2).sum() for g in grads[0].values()))
    assert (g_norm > max_norm) == (grad_scale > 1)

    optim = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr, eps=1e-5))
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = optim.init(j_params)
    port = ClipAdam(lr, max_norm, eps=1e-5)
    t_params = {k: t(v) for k, v in params.items()}
    t_state = port.init(t_params)
    for g in grads:  # three steps: the bias corrections change every step
        updates, j_state = optim.update({k: jnp.asarray(v) for k, v in g.items()}, j_state)
        j_params = optax.apply_updates(j_params, updates)
        t_updates, t_state = port.update({k: t(v) for k, v in g.items()}, t_state)
        t_params = apply_updates(t_params, t_updates)
        for k in params:
            np.testing.assert_allclose(n(t_params[k]), np.asarray(j_params[k]), rtol=0, atol=ATOL)
    assert t_state.count == 3
    for k in params:
        np.testing.assert_allclose(n(t_state.mu[k]), np.asarray(j_state[1][0].mu[k]), atol=ATOL)
        np.testing.assert_allclose(n(t_state.nu[k]), np.asarray(j_state[1][0].nu[k]), atol=ATOL)


def test_learning_rate_decay_matches_optax_schedule():
    config = Config.from_dict({"system": {"decay_learning_rates": True},
                               "arch": {"num_updates": 5}})
    port = make_learning_rate(1e-3, config, epochs=2, num_minibatches=3)
    ref = jax_make_learning_rate(1e-3, config, epochs=2, num_minibatches=3)
    for count in (0, 1, 7, 29, 30, 31):
        np.testing.assert_allclose(port(count), float(ref(count)), rtol=1e-6)
    config.system.decay_learning_rates = False
    assert make_learning_rate(1e-3, config) == 1e-3
    assert linear_schedule(1.0, 0.0, 4)(2) == 0.5
