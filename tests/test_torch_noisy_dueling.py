"""Rainbow's networks in the port (networks/layers.py::NoisyLinear,
networks/torso.py::NoisyMLPTorso, networks/dueling.py) against flax, on the
CPU, with the flax params carried across (utils/params.py) and the same
standard-normal noise fed to both packages (torch_parity.fed_normals): with
noise and without (the JAX layer's forward when no "noise" rng is given).
Outputs 1e-5 relative with an absolute floor of 1e-6; params round-trip
exactly; a missing, extra or misshapen leaf raises.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.networks import dueling as jdueling
from stoix_tpu.networks import layers as jlayers
from stoix_tpu.networks import torso as jtorso
from stoix_tpu_torch.networks import dueling, layers, torso
from stoix_tpu_torch.utils.params import load_flax_params
from torch_parity import fed_normals, n, noise_draws, to_flax_params

RTOL, ATOL = 1e-5, 1e-6
IN, BATCH = 6, 5


def _x(seed=0, lead=(BATCH,)):
    return np.random.default_rng(seed).normal(size=lead + (IN,)).astype(np.float32)


def _init(module, x):
    """flax params of `module` (its init draws noise too: fed zeros)."""
    with fed_normals([np.zeros(s, np.float32) for s in _normal_shapes(module, x)]):
        return jax.tree.map(np.asarray, module.init({"params": jax.random.PRNGKey(1),
                                                      "noise": jax.random.PRNGKey(2)},
                                                     jnp.asarray(x)))


def _normal_shapes(module, x):
    """The shapes of the normals a flax module draws, in order (traced)."""
    shapes = []
    original = jax.random.normal

    def record(key, shape=(), dtype=None):
        shapes.append(tuple(shape))
        return jnp.zeros(shape, jnp.float32)

    jax.random.normal = record
    try:
        jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(1),
                                            "noise": jax.random.PRNGKey(2)}, jnp.asarray(x)))
    finally:
        jax.random.normal = original
    return shapes


def _close(got, want):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _pair(flax_module, port_module, x):
    params = _init(flax_module, x)
    load_flax_params(port_module, params)
    back = to_flax_params(dict(port_module.named_parameters()), params)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, w), back, params)
    return params


def _both(flax_module, params, port_module, x, seed, **port_kwargs):
    """(flax out with fed noise, port out with the same noise, flax out with
    no noise rng, port out with noise=None)."""
    draws, pairs = noise_draws(port_module, seed)
    with fed_normals(draws) as left:
        noisy = flax_module.apply(params, jnp.asarray(x), rngs={"noise": jax.random.PRNGKey(0)})
        assert not left  # every draw consumed, each layer's pair in order
    quiet = flax_module.apply(params, jnp.asarray(x))
    t = torch.from_numpy(x)
    if isinstance(port_module, layers.NoisyLinear):
        pairs = pairs[0]  # a layer takes its own pair
    return noisy, port_module(t, noise=pairs, **port_kwargs), quiet, port_module(
        t, noise=None, **port_kwargs)


def test_noisy_linear_matches_flax_with_and_without_noise():
    x = _x(0)
    flax_layer, port_layer = jlayers.NoisyLinear(features=4), layers.NoisyLinear(IN, 4)
    params = _pair(flax_layer, port_layer, x)
    # flax stores mu_w and sigma_w as [in, out]; the port keeps that layout.
    assert params["params"]["mu_w"].shape == tuple(port_layer.mu_w.shape) == (IN, 4)
    noisy, got_noisy, quiet, got_quiet = _both(flax_layer, params, port_layer, x, seed=3)
    _close(got_noisy, noisy)
    _close(got_quiet, quiet)
    assert not np.allclose(np.asarray(noisy), np.asarray(quiet))
    # The stored means lie in [0, 2/sqrt(in)), as flax draws them, and the
    # sigmas start at sigma_zero/sqrt(in).
    fresh = layers.NoisyLinear(IN, 4, generator=torch.Generator().manual_seed(0))
    mu_w = n(fresh.mu_w)
    assert 0 <= mu_w.min() and mu_w.max() < 2 / np.sqrt(IN)
    assert np.allclose(n(fresh.sigma_w), 0.5 / np.sqrt(IN))


def test_noise_is_drawn_once_a_call_and_shared_by_the_batch():
    layer = layers.NoisyLinear(IN, 4, generator=torch.Generator().manual_seed(0))
    noise = layers.draw_noise(layer, torch.Generator().manual_seed(1))
    assert [tuple(e.shape) for e in noise[0]] == [(IN,), (4,)]
    x = torch.from_numpy(_x(1))
    rows = torch.cat([layer(x[i:i + 1], noise[0]) for i in range(BATCH)])
    torch.testing.assert_close(layer(x, noise[0]), rows, rtol=1e-6, atol=1e-7)
    again = layers.draw_noise(layer, torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(noise[0], again[0]))


@pytest.mark.parametrize("use_layer_norm", [False, True])
def test_noisy_mlp_torso_matches_flax(use_layer_norm):
    x = _x(2, lead=(3, BATCH))  # leading time and batch axes
    flax_torso = jtorso.NoisyMLPTorso((8, 7), use_layer_norm=use_layer_norm)
    port_torso = torso.NoisyMLPTorso(IN, (8, 7), use_layer_norm=use_layer_norm)
    params = _pair(flax_torso, port_torso, x)
    assert sorted(params["params"]) == (["LayerNorm_0", "LayerNorm_1"] if use_layer_norm
                                        else []) + ["NoisyLinear_0", "NoisyLinear_1"]
    outputs = _both(flax_torso, params, port_torso, x, seed=4)
    for got, want in zip(outputs[1::2], outputs[0::2]):
        _close(got, want)


HEADS = {
    "dueling": (lambda: jdueling.DuelingQNetwork(action_dim=3, layer_sizes=(8,)),
                lambda: dueling.DuelingQNetwork(3, IN, layer_sizes=(8,))),
    "distributional": (
        lambda: jdueling.DistributionalDuelingQNetwork(action_dim=3, num_atoms=11, vmin=-5.0,
                                                       vmax=5.0, layer_sizes=(8,)),
        lambda: dueling.DistributionalDuelingQNetwork(3, IN, num_atoms=11, vmin=-5.0, vmax=5.0,
                                                      layer_sizes=(8,))),
    "noisy": (
        lambda: jdueling.NoisyDistributionalDuelingQNetwork(action_dim=3, num_atoms=11,
                                                            vmin=0.0, vmax=10.0,
                                                            layer_sizes=(8,)),
        lambda: dueling.NoisyDistributionalDuelingQNetwork(3, IN, num_atoms=11, vmin=0.0,
                                                           vmax=10.0, layer_sizes=(8,))),
}


def _head_outputs(out):
    """(preferences, logits, atoms) of a head's output; the plain head's
    EpsilonGreedy alone."""
    if isinstance(out, tuple):
        return (out[0].preferences, out[1], out[2])
    return (out.preferences,)


@pytest.mark.parametrize("kind", list(HEADS))
def test_dueling_heads_match_flax(kind):
    make_flax, make_port = HEADS[kind]
    x = _x(5)
    flax_head, port_head = make_flax(), make_port()
    params = _pair(flax_head, port_head, x)
    assert sorted(params["params"]) == (
        ["NoisyMLPTorso_0", "NoisyMLPTorso_1"] if kind == "noisy" else ["MLPTorso_0",
                                                                          "MLPTorso_1"])
    if kind == "noisy":
        noisy, got_noisy, quiet, got_quiet = _both(flax_head, params, port_head, x, seed=6)
        pairs = [(got_noisy, noisy), (got_quiet, quiet)]
    else:
        pairs = [(port_head(torch.from_numpy(x)), flax_head.apply(params, jnp.asarray(x)))]
    for got, want in pairs:
        for g, w in zip(_head_outputs(got), _head_outputs(want)):
            _close(g, w)
        # Greedy acting agrees.
        assert np.array_equal(n(_head_outputs(got)[0].argmax(-1)),
                              np.asarray(jnp.argmax(_head_outputs(want)[0], -1)))


def test_misfit_noisy_params_raise():
    x = _x(0)
    flax_torso = jtorso.NoisyMLPTorso((8, 7))
    params = _init(flax_torso, x)
    port_torso = torso.NoisyMLPTorso(IN, (8, 7))
    missing = {"params": {**params["params"], "NoisyLinear_1": {
        k: v for k, v in params["params"]["NoisyLinear_1"].items() if k != "sigma_b"}}}
    with pytest.raises(ValueError, match=r"missing flax parameter for layers\.1\.sigma_b"):
        load_flax_params(port_torso, missing)
    extra = {"params": {**params["params"], "NoisyLinear_2": params["params"]["NoisyLinear_1"]}}
    with pytest.raises(ValueError, match=r"extra flax parameter layers\.2\.mu_w"):
        load_flax_params(port_torso, extra)
    wrong = {"params": {**params["params"], "NoisyLinear_0": {
        **params["params"]["NoisyLinear_0"],
        "mu_w": params["params"]["NoisyLinear_0"]["mu_w"].T}}}  # [out, in]: the wrong layout
    with pytest.raises(ValueError, match=r"layers\.0\.mu_w: flax shape"):
        load_flax_params(port_torso, wrong)
    assert isinstance(flax_torso, fnn.Module)
