"""Networks of the PyTorch port against the JAX package's flax modules, with
the SAME parameters carried across by utils/params.py::load_flax_params.

Tolerance: 1e-5 relative (1e-6 absolute floor) in float32 — the matmuls and
silu reduce and round in another order than XLA's. bf16 compute is held at
2e-2: both frameworks round activations to bf16 at different points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu_torch.networks import heads, inputs, torso
from stoix_tpu_torch.networks.base import FeedForwardActor, FeedForwardCritic
from stoix_tpu_torch.networks.utils import parse_activation_fn
from stoix_tpu_torch.utils.params import load_flax_params
from torch_parity import n, observations, paired_networks, to_flax_params

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("layer_norm", [False, True])
def test_actor_logits_and_critic_values_match_flax(layer_norm):
    ja, jap, jc, jcp, ta, tc = paired_networks(6, 3, (32, 32), use_layer_norm=layer_norm)
    jobs, tobs = observations(1, 8, 6, 3)
    want_logits = np.asarray(ja.apply(jap, jobs).logits)
    want_values = np.asarray(jc.apply(jcp, jobs))
    with torch.no_grad():
        got_logits = n(ta(tobs).logits)
        got_values = n(tc(tobs))
    assert got_values.shape == (8,)
    np.testing.assert_allclose(got_logits, want_logits, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_values, want_values, rtol=RTOL, atol=ATOL)


def test_actor_respects_action_mask_like_flax():
    mask = [1.0, 0.0, 1.0]
    ja, jap, _, _, ta, _ = paired_networks(6, 3, (32, 32))
    jobs, tobs = observations(2, 64, 6, 3, mask=mask)
    want = ja.apply(jap, jobs)
    with torch.no_grad():
        got = ta(tobs)
    legal = np.array(mask, bool)
    np.testing.assert_allclose(
        n(got.logits)[:, legal], np.asarray(want.logits)[:, legal], rtol=RTOL, atol=ATOL
    )
    assert np.all(n(got.probs)[:, ~legal] == 0.0)
    samples = got.sample(torch.Generator().manual_seed(0))
    assert not np.any(n(samples) == 1)


def test_bf16_compute_dtype_matches_flax():
    import jax

    from stoix_tpu.networks import torso as jtorso

    jnet = jtorso.MLPTorso((32, 32), compute_dtype="bfloat16")
    x = np.random.default_rng(3).normal(size=(8, 6)).astype(np.float32)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tnet = load_flax_params(torso.MLPTorso(6, (32, 32), compute_dtype="bfloat16"), params)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    np.testing.assert_allclose(n(got), np.asarray(jnet.apply(params, jnp.asarray(x))),
                               rtol=2e-2, atol=2e-2)


def test_param_carry_across_round_trips_and_fails_loudly():
    ja, jap, _, _, ta, _ = paired_networks(6, 3, (32, 32))
    back = to_flax_params(dict(ta.named_parameters()), jap)
    for path in (("torso", "Dense_0", "kernel"), ("action_head", "Dense_0", "bias")):
        want, got = jap["params"], back["params"]
        for key in path:
            want, got = want[key], got[key]
        np.testing.assert_array_equal(got, want)

    missing = {"params": {"torso": dict(jap["params"]["torso"])}}
    with pytest.raises(ValueError, match="missing flax parameter for action_head"):
        load_flax_params(ta, missing)
    extra = {"params": {**jap["params"], "torso": {**jap["params"]["torso"],
                                                    "Dense_5": {"kernel": np.zeros((32, 32)),
                                                                "bias": np.zeros(32)}}}}
    with pytest.raises(ValueError, match="extra flax parameter torso.dense.5"):
        load_flax_params(ta, extra)
    wrong = {"params": {**jap["params"], "action_head": {"Dense_0": {
        "kernel": np.zeros((32, 5), np.float32), "bias": np.zeros(5, np.float32)}}}}
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(ta, wrong)


def test_inits_follow_flax_scales():
    gen = torch.Generator().manual_seed(0)
    t_net = torso.MLPTorso(4, (64, 64), generator=gen)
    head = heads.CategoricalHead(3, 64, generator=gen)
    critic = heads.ScalarCriticHead(64, generator=gen)
    # Orthogonal rows scaled by the gain; zero biases.
    for layer, gain in ((t_net.dense[1], 2**0.5), (head.dense[0], 0.01), (critic.dense[0], 1.0)):
        w = layer.weight.detach()
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(n(gram), gain**2 * np.eye(gram.shape[0]), atol=1e-5)
        assert torch.count_nonzero(layer.bias) == 0


def test_feedforward_modules_compose_like_flax():
    actor = FeedForwardActor(
        heads.CategoricalHead(3, 8), torso.MLPTorso(5, (8,)), inputs.ObservationInput()
    )
    critic = FeedForwardCritic(
        heads.ScalarCriticHead(8), torso.MLPTorso(5, (8,)), inputs.ObservationInput()
    )
    _, tobs = observations(4, 7, 5, 3)
    with torch.no_grad():
        assert actor(tobs).logits.shape == (7, 3)
        assert critic(tobs).shape == (7,)
        assert actor.torso(tobs.agent_view).shape == (7, 8)
    with pytest.raises(ValueError, match="Unknown activation"):
        parse_activation_fn("nope")
