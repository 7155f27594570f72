"""The MuZero family's networks of the PyTorch port against the JAX
package's, on the CPU, at small widths, with the flax params carried over
by utils/params.py::load_flax_params (1e-5 relative, 1e-6 absolute):

  - StackedRNN (networks/layers.py) with LSTM and GRU cells, one step from
    random carries;
  - RewardBasedWorldModel (networks/model_based.py): `initial_state`,
    `step`, and the packing ([c_0, h_0, c_1, h_1, ...] for LSTMs), with
    ff_mz's one-hot and ff_sampled_mz's MLP action embedders;
  - MLPLogitsHead and the latent policies (Categorical, tanh-Gaussian);
  - the post-processors (networks/postprocessors.py), `min_max_normalize`
    at epsilon 1e-5;
  - `scale_gradient` (utils/training.py): the forward exact, the gradient
    against `jax.grad`;
  - a world-model tree with a missing, an extra or a misshapen leaf raises,
    naming it.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.networks import heads as jheads, postprocessors as jpost, torso as jtorso
from stoix_tpu.networks.layers import StackedRNN as JaxStackedRNN
from stoix_tpu.networks.model_based import RewardBasedWorldModel as JaxWorldModel
from stoix_tpu.ops.distributions import Normal as JaxNormal
from stoix_tpu.utils.jax_utils import scale_gradient as jax_scale_gradient
from stoix_tpu_torch.networks import heads, postprocessors
from stoix_tpu_torch.networks.layers import StackedRNN
from stoix_tpu_torch.networks.model_based import (
    ActionOneHot, LatentPolicy, RewardBasedWorldModel,
)
from stoix_tpu_torch.networks.torso import MLPTorso
from stoix_tpu_torch.ops.distributions import Normal
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.training import scale_gradient
from torch_parity import n, t

HIDDEN, OBS, ACTIONS, ATOMS, BATCH = 8, 5, 3, 21, 6


def close(got, want):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-6)


class JaxActionOneHot(nn.Module):
    num_actions: int

    @nn.compact
    def __call__(self, action):
        return jax.nn.one_hot(action, self.num_actions)


def world_models(cell, layers, discrete):
    """(flax world model, its params, the port's with the same params)."""
    jax_embedder = (JaxActionOneHot(ACTIONS) if discrete else
                    jtorso.MLPTorso((HIDDEN // 2,)))
    jwm = JaxWorldModel(obs_encoder=jtorso.MLPTorso((HIDDEN,)),
                        reward_head=jheads.MLPLogitsHead(num_outputs=ATOMS,
                                                         hidden_sizes=(HIDDEN,)),
                        action_embedder=jax_embedder, hidden_size=HIDDEN,
                        num_rnn_layers=layers, rnn_cell_type=cell)
    action = jnp.zeros((1,), jnp.int32) if discrete else jnp.zeros((1, ACTIONS))
    params = jax.tree.map(np.asarray, jwm.init(jax.random.PRNGKey(1), jnp.zeros((1, OBS)),
                                               action))
    embedder = ActionOneHot(ACTIONS) if discrete else MLPTorso(ACTIONS, (HIDDEN // 2,))
    wm = RewardBasedWorldModel(MLPTorso(OBS, (HIDDEN,)),
                               heads.MLPLogitsHead(ATOMS, HIDDEN, (HIDDEN,)), embedder,
                               HIDDEN, layers, cell)
    load_flax_params(wm, params)
    return jwm, params, wm


def actions(seed, discrete):
    rng = np.random.default_rng(seed)
    if discrete:
        return rng.integers(0, ACTIONS, BATCH).astype(np.int32)
    return rng.uniform(-1, 1, (BATCH, ACTIONS)).astype(np.float32)


@pytest.mark.parametrize("cell,layers", [("lstm", 2), ("gru", 1), ("lstm", 1), ("gru", 2)])
def test_stacked_rnn_step_matches_flax(cell, layers):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, OBS)).astype(np.float32)
    jrnn = JaxStackedRNN(HIDDEN, layers, cell)
    carry = jrnn.initialize_carry(None, (BATCH, OBS))
    carry = jax.tree.map(lambda c: jnp.asarray(rng.normal(size=c.shape), jnp.float32), carry)
    params = jax.tree.map(np.asarray, jrnn.init(jax.random.PRNGKey(0), carry, x))
    want_carry, want_out = jrnn.apply(params, carry, x)
    rnn = StackedRNN(OBS, HIDDEN, layers, cell)
    load_flax_params(rnn, params)
    got_carry, got_out = rnn(jax.tree.map(t, carry), t(x))
    close(got_out, want_out)
    for g, w in zip(jax.tree.leaves(jax.tree.map(n, got_carry, is_leaf=torch.is_tensor)),
                    jax.tree.leaves(want_carry)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)
    zeros = rnn.initialize_carry((BATCH,))
    assert len(zeros) == layers
    flat = [z for c in zeros for z in (c if isinstance(c, tuple) else (c,))]
    assert all(bool((z == 0).all()) and z.shape == (BATCH, HIDDEN) for z in flat)


@pytest.mark.parametrize("cell,layers,discrete", [("lstm", 2, True), ("gru", 1, True),
                                                  ("lstm", 1, False), ("gru", 2, False)])
def test_world_model_initial_state_and_step_match_flax(cell, layers, discrete):
    jwm, params, wm = world_models(cell, layers, discrete)
    obs = np.random.default_rng(3).normal(size=(BATCH, OBS)).astype(np.float32)
    want_latent = jwm.apply(params, obs, method="initial_state")
    got_latent = wm("initial_state", t(obs))
    assert got_latent.shape == (BATCH, wm.latent_dim)
    close(got_latent, want_latent)
    action = actions(4, discrete)
    want_next, want_reward = jwm.apply(params, want_latent, action, method="step")
    got_next, got_reward = wm("step", t(np.asarray(want_latent)), t(action))
    close(got_next, want_next)
    close(got_reward, want_reward)
    assert got_reward.shape == (BATCH, ATOMS)
    # A second step from the first's latent (the search's unroll).
    want_2, _ = jwm.apply(params, want_next, action, method="step")
    close(wm("step", got_next, t(action))[0], want_2)


def test_world_model_packs_lstm_carries_c_then_h_a_layer():
    _, _, wm = world_models("lstm", 2, True)
    c0, h0, c1, h1 = (torch.full((2, HIDDEN), float(i)) for i in range(4))
    flat = wm.pack_state(((c0, h0), (c1, h1)))
    np.testing.assert_array_equal(n(flat[0]), np.repeat(np.arange(4.0), HIDDEN))
    (uc0, uh0), (uc1, uh1) = wm.unpack_state(flat)
    for got, want in ((uc0, c0), (uh0, h0), (uc1, c1), (uh1, h1)):
        assert torch.equal(got, want)
    # initial_state seeds each layer's h with the projection, its c with 0.
    latent = wm("initial_state", torch.randn(4, OBS)).detach()
    (c_a, h_a), (c_b, h_b) = wm.unpack_state(latent)
    assert torch.equal(c_a, c_b) and torch.equal(h_a, h_b)
    assert bool((c_a == c_a[:, :1]).all())  # 0 before the normalisation: one value a row


def test_mlp_logits_head_and_latent_policies_match_flax():
    rng = np.random.default_rng(5)
    latent = rng.normal(size=(BATCH, 16)).astype(np.float32)
    jhead = jheads.MLPLogitsHead(num_outputs=ATOMS, hidden_sizes=(HIDDEN,))
    params = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(2), latent))
    head = heads.MLPLogitsHead(ATOMS, 16, (HIDDEN,))
    load_flax_params(head, params)
    close(head(t(latent)), jhead.apply(params, latent))

    for continuous in (False, True):
        class JaxLatentPolicy(nn.Module):
            @nn.compact
            def __call__(self, x):
                x = jtorso.MLPTorso((HIDDEN,))(x)
                if continuous:
                    return jheads.NormalAffineTanhDistributionHead(
                        action_dim=ACTIONS, minimum=-2.0, maximum=2.0)(x)
                return jheads.CategoricalHead(num_actions=ACTIONS)(x)

        jpolicy = JaxLatentPolicy()
        pparams = jax.tree.map(np.asarray, jpolicy.init(jax.random.PRNGKey(3), latent))
        head = (heads.NormalAffineTanhDistributionHead(ACTIONS, HIDDEN, -2.0, 2.0) if continuous
                else heads.CategoricalHead(ACTIONS, HIDDEN))
        policy = LatentPolicy(MLPTorso(16, (HIDDEN,)), head)
        load_flax_params(policy, pparams)
        want, got = jpolicy.apply(pparams, latent), policy(t(latent))
        if continuous:
            sample = rng.uniform(-1.9, 1.9, (BATCH, ACTIONS)).astype(np.float32)
            close(got.log_prob(t(sample)), want.log_prob(sample))
            close(got.mode(), want.mode())
        else:
            close(got.logits, want.logits)


def test_post_processors_match_the_jax_package():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(BATCH, 12)).astype(np.float32) * 3
    close(postprocessors.min_max_normalize(t(x)), jpost.min_max_normalize(x))
    flat = np.ones((2, 5), np.float32)  # max - min = 0: divided by the epsilon
    close(postprocessors.min_max_normalize(t(flat)), jpost.min_max_normalize(flat))
    for name in ("rescale_to_spec", "clip_to_spec", "tanh_to_spec"):
        close(getattr(postprocessors, name)(t(x), -2.0, 3.0), getattr(jpost, name)(x, -2.0, 3.0))
    loc, scale = x[:, :3], np.abs(x[:, 3:6]) + 0.1
    jdist = jpost.ScalePostProcessor(-2.0, 3.0).apply({}, JaxNormal(loc, scale))
    dist = postprocessors.ScalePostProcessor(-2.0, 3.0)(Normal(t(loc), t(scale)))
    close(dist.mode(), jdist.mode())
    close(dist.mean(), jdist.mean())
    noise = rng.normal(size=loc.shape).astype(np.float32)
    want = jpost.tanh_to_spec(loc + scale * noise, -2.0, 3.0)
    close(dist.sample(noise=t(noise)), want)
    close(dist.stddev(), scale)  # delegated to the wrapped distribution


def test_scale_gradient_is_identity_forward_and_scales_the_gradient():
    x = np.random.default_rng(7).normal(size=(4, 5)).astype(np.float32)
    got = scale_gradient(t(x), 0.5)
    np.testing.assert_array_equal(n(got), x)
    np.testing.assert_array_equal(np.asarray(jax_scale_gradient(jnp.asarray(x), 0.5)), x)
    want = jax.grad(lambda v: jnp.sum(jax_scale_gradient(v, 0.25) ** 2))(jnp.asarray(x))
    leaf = t(x).requires_grad_(True)
    torch.sum(scale_gradient(leaf, 0.25) ** 2).backward()
    np.testing.assert_allclose(n(leaf.grad), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_world_model_tree_that_does_not_fit_raises_naming_the_leaf(fault):
    _, params, wm = world_models("lstm", 1, True)
    tree = jax.tree.map(lambda x: x, params)
    cell = tree["params"]["dynamics"]["cells_0"]
    if fault == "missing":
        del cell["hi"]
        match = "missing flax parameter for dynamics.cells.0.hi"
    elif fault == "extra":
        tree["params"]["reward_head"]["Dense_1"] = {"bias": np.zeros(3, np.float32)}
        match = "extra flax parameter reward_head.dense.1.bias"
    else:
        cell["ii"]["kernel"] = np.zeros((ACTIONS + 1, HIDDEN), np.float32)
        match = "dynamics.cells.0.ii.weight"
    with pytest.raises(ValueError, match=match):
        load_flax_params(wm, tree)
