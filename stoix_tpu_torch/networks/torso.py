"""Torso networks (counterpart of stoix_tpu/networks/torso.py: MLPTorso,
NoisyMLPTorso and CNNTorso).

flax infers a layer's input size at init; an `nn.Linear` or `nn.Conv2d` needs
it up front, so the MLP torsos take `input_dim` and the conv torsos
`input_shape`, one env's observation shape (`systems/anakin.py::
torso_input_kwargs` gives each what it takes), and every module exposes
`output_dim` for the next one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stoix_tpu_torch.networks.cells import lecun_normal
from stoix_tpu_torch.networks.layers import Noise, NoisyLinear
from stoix_tpu_torch.networks.utils import parse_activation_fn


def silu_rounded_per_op(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` in a low-precision dtype as XLA evaluates it:
    x * (1 / (1 + exp(-x))), each op rounded to `x.dtype` (F.silu rounds once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def init_linear(
    layer: nn.Linear, scale: float, generator: Optional[torch.Generator]
) -> nn.Linear:
    """Orthogonal weight with gain `scale` (flax's orthogonal kernel init, on
    the transposed layout) and a zero bias."""
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=scale, generator=generator)
        layer.bias.zero_()
    return layer


class MLPTorso(nn.Module):
    """Dense -> (LayerNorm) -> activation, per layer size.

    `compute_dtype="bfloat16"` runs the matmuls and activations in bf16 while
    parameters stay float32 (flax Dense dtype semantics), rounding where flax
    rounds; the output is cast back to float32 so losses keep full precision."""

    def __init__(
        self,
        input_dim: int,
        layer_sizes: Sequence[int] = (256, 256),
        activation: str = "silu",
        use_layer_norm: bool = False,
        activate_final: bool = True,
        kernel_scale: float = 1.4142135,  # sqrt(2)
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        sizes = [int(input_dim)] + [int(s) for s in layer_sizes]
        self.dense = nn.ModuleList(
            init_linear(nn.Linear(i, o), kernel_scale, generator)
            for i, o in zip(sizes[:-1], sizes[1:])
        )
        # flax LayerNorm: eps 1e-6, learned scale and bias.
        self.norm = nn.ModuleList(
            nn.LayerNorm(o, eps=1e-6) for o in sizes[1:] if use_layer_norm
        )
        self.output_dim = sizes[-1]
        self._activate_final = bool(activate_final)
        self._dtype = getattr(torch, compute_dtype)
        low_precision_silu = self._dtype != torch.float32 and activation in ("silu", "swish")
        self._act = silu_rounded_per_op if low_precision_silu else parse_activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self._dtype
        x = x.to(dtype)
        n_layers = len(self.dense)
        for i, layer in enumerate(self.dense):
            if dtype == torch.float32:
                x = F.linear(x, layer.weight, layer.bias)
            else:
                # flax Dense(dtype): input, kernel and bias cast to `dtype`; the
                # product is rounded to `dtype` before the bias is added in it.
                x = F.linear(x, layer.weight.to(dtype)) + layer.bias.to(dtype)
            if len(self.norm):
                # flax LayerNorm(dtype): statistics and normalisation in float32,
                # one cast to `dtype` at the end.
                norm = self.norm[i]
                x = F.layer_norm(
                    x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps
                ).to(dtype)
            if i < n_layers - 1 or self._activate_final:
                x = self._act(x)
        return x.to(torch.float32)


class NoisyMLPTorso(nn.Module):
    """NoisyLinear -> (LayerNorm) -> activation, per layer size (NoisyNets).
    `noise` is one (e_in, e_out) pair a layer (layers/noisy_layers order), or
    None for the noise-free forward (flax's layer with no "noise" rng)."""

    def __init__(
        self,
        input_dim: int,
        layer_sizes: Sequence[int] = (256, 256),
        activation: str = "relu",
        use_layer_norm: bool = False,
        activate_final: bool = True,
        sigma_zero: float = 0.5,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        sizes = [int(input_dim)] + [int(s) for s in layer_sizes]
        self.layers = nn.ModuleList(
            NoisyLinear(i, o, sigma_zero, generator) for i, o in zip(sizes[:-1], sizes[1:]))
        self.norm = nn.ModuleList(
            nn.LayerNorm(o, eps=1e-6) for o in sizes[1:] if use_layer_norm)
        self.output_dim = sizes[-1]
        self._activate_final = bool(activate_final)
        self._act = parse_activation_fn(activation)

    def forward(self, x: torch.Tensor, noise: Optional[Sequence[Noise]] = None) -> torch.Tensor:
        n_layers = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x, None if noise is None else noise[i])
            if len(self.norm):
                x = self.norm[i](x)
            if i < n_layers - 1 or self._activate_final:
                x = self._act(x)
        return x


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's (XLA's) "SAME" padding of one spatial axis of `size`: the
    output is ceil(size / stride) wide and the odd pixel of the padding goes
    after, so (before, after) may differ by one."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """flax's `nn.Conv(padding="SAME")` on NCHW tensors of spatial size
    `in_hw`: its padding is symmetric where flax's is, else an explicit
    `F.pad` first; the kernel LeCun normal, the bias zero (flax's init).
    `dtype` other than float32 rounds as flax's Conv(dtype): the product in
    `dtype`, then the bias added in it."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int,
                 in_hw: Sequence[int], generator: Optional[torch.Generator] = None):
        pads = [same_padding(int(size), kernel, stride) for size in in_hw]
        symmetric = all(before == after for before, after in pads)
        super().__init__(in_channels, out_channels, kernel, stride,
                         padding=tuple(before for before, _ in pads) if symmetric else 0)
        (top, bottom), (left, right) = pads
        self.explicit_pad = None if symmetric else (left, right, top, bottom)
        self.out_hw = tuple(-(-int(size) // stride) for size in in_hw)
        lecun_normal(self, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if self.explicit_pad is not None:
            x = F.pad(x, self.explicit_pad)
        if dtype == torch.float32:
            return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)
        y = F.conv2d(x, self.weight.to(dtype), None, self.stride, self.padding)
        return y + self.bias.to(dtype)[:, None, None]


def channel_layer_norm(x: torch.Tensor, norm: nn.LayerNorm,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax's LayerNorm after a conv: over the channels of each pixel only
    (NCHW here), statistics in float32, one cast to `dtype` at the end."""
    y = F.layer_norm(x.float().permute(0, 2, 3, 1), norm.normalized_shape, norm.weight,
                     norm.bias, norm.eps)
    return y.permute(0, 3, 1, 2).to(dtype)


def image_batch(x: torch.Tensor, channel_first: bool) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """[..., H, W, C] (or [..., C, H, W]) -> ([B, C, H, W], the leading dims)."""
    lead = tuple(x.shape[:-3])
    x = x.reshape((-1,) + tuple(x.shape[-3:]))
    return (x if channel_first else x.permute(0, 3, 1, 2)), lead


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H.W.C], flattened in flax's NHWC order so a
    carried Dense kernel applies unchanged."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def image_hwc(input_shape: Sequence[int], channel_first: bool) -> Tuple[int, int, int]:
    """(H, W, C) of one observation's shape."""
    shape = tuple(int(s) for s in input_shape[-3:])
    return (shape[1], shape[2], shape[0]) if channel_first else shape


class CNNTorso(nn.Module):
    """Conv -> (LayerNorm) -> activation per channel size, then a flatten and
    Dense -> activation per hidden size, on NHWC inputs with any leading dims
    ([B, H, W, C], [T, B, H, W, C]); `channel_first` takes NCHW. The convs
    pad as flax's "SAME" and the flatten is flax's NHWC order, so a carried
    flax tree (Conv_i, LayerNorm_i, Dense_i) applies as it is. Dense kernels
    are orthogonal (sqrt 2), conv kernels LeCun normal, biases zero."""

    def __init__(
        self,
        input_shape: Sequence[int],
        channel_sizes: Sequence[int] = (32, 64, 64),
        kernel_sizes: Sequence[int] = (8, 4, 3),
        strides: Sequence[int] = (4, 2, 1),
        activation: str = "relu",
        use_layer_norm: bool = False,
        hidden_sizes: Sequence[int] = (256,),
        channel_first: bool = False,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        height, width, channels = image_hwc(input_shape, channel_first)
        hw = (height, width)
        self.conv = nn.ModuleList()
        for out_channels, kernel, stride in zip(channel_sizes, kernel_sizes, strides):
            conv = SameConv2d(channels, int(out_channels), int(kernel), int(stride), hw, generator)
            self.conv.append(conv)
            channels, hw = int(out_channels), conv.out_hw
        self.norm = nn.ModuleList(
            nn.LayerNorm(int(c), eps=1e-6) for c in channel_sizes if use_layer_norm)
        sizes = [channels * math.prod(hw)] + [int(s) for s in hidden_sizes]
        self.dense = nn.ModuleList(
            init_linear(nn.Linear(i, o), math.sqrt(2.0), generator)
            for i, o in zip(sizes[:-1], sizes[1:]))
        self.output_dim = sizes[-1]
        self._channel_first = bool(channel_first)
        self._dtype = getattr(torch, compute_dtype)
        self._act = parse_activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self._dtype
        x, lead = image_batch(x.to(dtype), self._channel_first)
        for i, conv in enumerate(self.conv):
            x = conv(x, dtype)
            if len(self.norm):
                x = channel_layer_norm(x, self.norm[i], dtype)
            x = self._act(x)
        x = flatten_nhwc(x)
        for layer in self.dense:
            if dtype == torch.float32:
                x = F.linear(x, layer.weight, layer.bias)
            else:
                x = F.linear(x, layer.weight.to(dtype)) + layer.bias.to(dtype)
            x = self._act(x)
        return x.reshape(lead + (x.shape[-1],)).to(torch.float32)
