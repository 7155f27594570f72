"""The port's conv and residual torsos against the JAX package's flax
modules, with the flax init carried over by utils/params.py::load_flax_params:
CNNTorso (network=cnn at 10x10x4, cnn_atari at 84x84x4, LayerNorm,
channel_first, leading [T, B] dims), VisualResNetTorso (the three
downsampling strategies, with and without LayerNorm) and MLPResNetTorso.

Tolerance: float32 outputs within 1e-5 relative, with an absolute floor of
1e-6 of the output's scale (its largest magnitude, at least 1): convolutions
and LayerNorm statistics sum in another order than XLA's, and an output near
zero keeps the absolute error of the sums behind it. The visual ResNet's
floor is 2e-6 of its scale: nine convolutions of up to 288-term sums and
four residual adds stand behind each output (the worst case measured, both
LayerNorm settings of `layernorm+relu+conv`, is 1.35e-6 of the scale).
CNNTorso in bfloat16 within 3e-2 relative (a floor of 3e-2 of the scale): every conv
output is rounded to bfloat16 (8 significant bits, a half-ulp of 2e-3), and
a rounding that falls the other way than XLA's on one activation moves
everything after it by up to an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.networks import resnet as jresnet, torso as jtorso
from stoix_tpu_torch.networks import resnet, torso
from stoix_tpu_torch.utils.params import load_flax_params
from torch_parity import n, t


def _paired(jax_module, port_module, shape, seed=0):
    """(flax output, port output) on the same numpy input of `shape`, the
    port module carrying the flax init."""
    x = np.random.default_rng(seed).uniform(0.0, 1.0, size=shape).astype(np.float32)
    params = jax.tree.map(np.asarray, jax_module.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    load_flax_params(port_module, params)
    want = np.asarray(jax.jit(jax_module.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = n(port_module(t(x)))
    return want, got, params


def _close(got, want, rtol=1e-5, floor=1e-6):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * scale)


CNN = dict(channel_sizes=(16, 32), kernel_sizes=(3, 3), strides=(1, 1), hidden_sizes=(128,))
CNN_ATARI = dict(channel_sizes=(32, 64, 64), kernel_sizes=(8, 4, 3), strides=(4, 2, 1),
                 hidden_sizes=(512,))
CNN_CASES = {
    "cnn": (CNN, (6, 10, 10, 4)),
    "cnn_atari": (CNN_ATARI, (3, 84, 84, 4)),
    "cnn_layer_norm": ({**CNN, "use_layer_norm": True}, (6, 10, 10, 4)),
    "cnn_leading_t_b": (CNN, (3, 4, 10, 10, 4)),
    "cnn_channel_first": ({**CNN, "channel_first": True}, (5, 4, 10, 10)),
    "cnn_stride_4_odd_sides": (dict(channel_sizes=(8, 8), kernel_sizes=(4, 3),
                                    strides=(2, 2), hidden_sizes=(16,)), (2, 13, 9, 3)),
}


@pytest.mark.parametrize("case", list(CNN_CASES))
def test_cnn_torso_matches_flax(case):
    kwargs, shape = CNN_CASES[case]
    per_env = shape[-3:]
    port = torso.CNNTorso(per_env, **kwargs)
    want, got, params = _paired(jtorso.CNNTorso(**kwargs), port, shape)
    _close(got, want)
    if case == "cnn_atari":
        # SAME padding (1, 2) on the second conv: 11x11x64 reach the Dense.
        assert params["params"]["Dense_0"]["kernel"].shape == (7744, 512)
        assert tuple(port.dense[0].weight.shape) == (512, 7744)


def test_cnn_torso_in_bfloat16_matches_flax_within_its_rounding():
    kwargs = {**CNN, "compute_dtype": "bfloat16"}
    want, got, _ = _paired(jtorso.CNNTorso(**kwargs), torso.CNNTorso((10, 10, 4), **kwargs),
                           (6, 10, 10, 4))
    assert got.dtype == np.float32
    _close(got, want, rtol=3e-2, floor=3e-2)


def test_symmetric_padding_cnn_torso_is_refused():
    """A torso padding symmetrically (Conv2d(padding=1) on cnn_atari's second
    conv) flattens 10x10x64 = 6400 features, not flax's 7744: its Dense
    cannot take the carried kernel."""

    class SymmetricCNNTorso(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.ModuleList([
                torch.nn.Conv2d(4, 32, 8, 4, padding=2), torch.nn.Conv2d(32, 64, 4, 2, padding=1),
                torch.nn.Conv2d(64, 64, 3, 1, padding=1)])
            self.dense = torch.nn.ModuleList([torch.nn.Linear(6400, 512)])

    x = jnp.zeros((1, 84, 84, 4), jnp.float32)
    params = jtorso.CNNTorso(**CNN_ATARI).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match=r"dense\.0\.weight"):
        load_flax_params(SymmetricCNNTorso(), params)


RESNET = dict(channels_per_group=(16, 32), blocks_per_group=(2, 2), hidden_sizes=(256,))


@pytest.mark.parametrize("strategy", ["conv+max", "layernorm+relu+conv", "conv"])
@pytest.mark.parametrize("use_layer_norm", [False, True])
def test_visual_resnet_torso_matches_flax(strategy, use_layer_norm):
    kwargs = dict(RESNET, downsampling_strategy=strategy, use_layer_norm=use_layer_norm)
    port = resnet.VisualResNetTorso((10, 10, 4), **kwargs)
    want, got, params = _paired(jresnet.VisualResNetTorso(**kwargs), port, (2, 3, 10, 10, 4))
    _close(got, want, floor=2e-6)
    # Two groups halve 10x10 to 5x5 and 3x3: 3.3.32 features reach the Dense.
    assert params["params"]["Dense_0"]["kernel"].shape == (288, 256)


def test_visual_resnet_max_pool_pads_like_flax_on_84():
    kwargs = dict(channels_per_group=(8,), blocks_per_group=(1,), hidden_sizes=(16,))
    want, got, _ = _paired(jresnet.VisualResNetTorso(**kwargs),
                           resnet.VisualResNetTorso((84, 84, 4), **kwargs), (2, 84, 84, 4))
    _close(got, want, floor=2e-6)


@pytest.mark.parametrize("use_layer_norm", [True, False])
def test_mlp_resnet_torso_matches_flax(use_layer_norm):
    kwargs = dict(num_blocks=2, hidden_size=64, use_layer_norm=use_layer_norm)
    want, got, _ = _paired(jresnet.MLPResNetTorso(**kwargs),
                           resnet.MLPResNetTorso(4, **kwargs), (16, 4))
    _close(got, want)
