"""Residual torsos (counterpart of stoix_tpu/networks/resnet.py): the
IMPALA-style visual ResNet with its three downsampling strategies, and the
MLP ResNet.

The visual torso runs NCHW inside and takes NHWC observations with any
leading dims, as CNNTorso does (networks/torso.py). Its modules carry flax's
names: the downsampling convs, flax's `Conv_i` in the torso's own scope (one
a group), are `conv.i`; the strategy's LayerNorms `LayerNorm_i` are `norm.i`;
`ResidualBlock_i` is `blocks.i` with its own `conv.0`, `conv.1` (and
`norm.0`, `norm.1`); `Dense_i` is `dense.i`. The MLP torso's
`MLPResidualBlock_i` is `blocks.i`, with `dense.0`, `dense.1`, `norm.0` and
`norm.1`. Conv and plain Dense kernels are LeCun normal (flax's default),
the visual torso's hidden Denses orthogonal (sqrt 2), biases zero.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stoix_tpu_torch.networks.cells import lecun_normal
from stoix_tpu_torch.networks.torso import (
    SameConv2d, channel_layer_norm, flatten_nhwc, image_batch, image_hwc, init_linear,
    same_padding,
)
from stoix_tpu_torch.networks.utils import parse_activation_fn


class DownsamplingStrategy:
    CONV_MAX = "conv+max"  # IMPALA: stride-1 conv then 3x3 max-pool stride 2
    LAYERNORM_RELU_CONV = "layernorm+relu+conv"  # MuZero-style strided conv
    CONV = "conv"


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax's `nn.max_pool(window (3, 3), strides (2, 2), padding="SAME")` on
    NCHW: -inf padding, the odd pixel after (0, 1 on an even side)."""
    (top, bottom), (left, right) = (same_padding(int(s), 3, 2) for s in x.shape[-2:])
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, kernel_size=3, stride=2)


class ResidualBlock(nn.Module):
    """x + [(LayerNorm) -> activation -> 3x3 conv] twice, on NCHW."""

    def __init__(self, channels: int, in_hw: Sequence[int], activation: str = "relu",
                 use_layer_norm: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.ModuleList(
            SameConv2d(channels, channels, 3, 1, in_hw, generator) for _ in range(2))
        self.norm = nn.ModuleList(
            nn.LayerNorm(channels, eps=1e-6) for _ in range(2) if use_layer_norm)
        self._act = parse_activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i, conv in enumerate(self.conv):
            if len(self.norm):
                y = channel_layer_norm(y, self.norm[i])
            y = conv(self._act(y))
        return x + y


class VisualResNetTorso(nn.Module):
    """IMPALA-style conv ResNet: per group a downsampling step then residual
    blocks; an activation, the NHWC flatten and Dense -> activation per
    hidden size."""

    def __init__(
        self,
        input_shape: Sequence[int],
        channels_per_group: Sequence[int] = (16, 32, 32),
        blocks_per_group: Sequence[int] = (2, 2, 2),
        downsampling_strategy: str = DownsamplingStrategy.CONV_MAX,
        activation: str = "relu",
        use_layer_norm: bool = False,
        hidden_sizes: Sequence[int] = (256,),
        channel_first: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        strategies = (DownsamplingStrategy.CONV_MAX, DownsamplingStrategy.LAYERNORM_RELU_CONV,
                      DownsamplingStrategy.CONV)
        if downsampling_strategy not in strategies:
            raise ValueError(f"Unknown downsampling strategy '{downsampling_strategy}'")
        self._strategy = downsampling_strategy
        height, width, channels = image_hwc(input_shape, channel_first)
        hw: Tuple[int, ...] = (height, width)
        self.conv, self.norm, self.blocks = nn.ModuleList(), nn.ModuleList(), nn.ModuleList()
        for group_channels, blocks in zip(channels_per_group, blocks_per_group):
            group_channels = int(group_channels)
            if self._strategy == DownsamplingStrategy.LAYERNORM_RELU_CONV:
                self.norm.append(nn.LayerNorm(channels, eps=1e-6))
            stride = 1 if self._strategy == DownsamplingStrategy.CONV_MAX else 2
            self.conv.append(SameConv2d(channels, group_channels, 3, stride, hw, generator))
            hw = tuple(-(-s // 2) for s in hw)
            channels = group_channels
            for _ in range(int(blocks)):
                self.blocks.append(
                    ResidualBlock(channels, hw, activation, use_layer_norm, generator))
        self._blocks_per_group = [int(b) for b in blocks_per_group]
        sizes = [channels * math.prod(hw)] + [int(s) for s in hidden_sizes]
        self.dense = nn.ModuleList(
            init_linear(nn.Linear(i, o), math.sqrt(2.0), generator)
            for i, o in zip(sizes[:-1], sizes[1:]))
        self.output_dim = sizes[-1]
        self._channel_first = bool(channel_first)
        self._act = parse_activation_fn(activation)

    def _downsample(self, x: torch.Tensor, group: int) -> torch.Tensor:
        if self._strategy == DownsamplingStrategy.CONV_MAX:
            return max_pool_same(self.conv[group](x))
        if self._strategy == DownsamplingStrategy.LAYERNORM_RELU_CONV:
            x = self._act(channel_layer_norm(x, self.norm[group]))
        return self.conv[group](x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, lead = image_batch(x, self._channel_first)
        block = 0
        for group, count in enumerate(self._blocks_per_group):
            x = self._downsample(x, group)
            for _ in range(count):
                x = self.blocks[block](x)
                block += 1
        x = flatten_nhwc(self._act(x))
        for layer in self.dense:
            x = self._act(layer(x))
        return x.reshape(lead + (x.shape[-1],))


class MLPResidualBlock(nn.Module):
    """x + [(LayerNorm) -> activation -> Dense] twice."""

    def __init__(self, hidden_size: int, activation: str = "relu", use_layer_norm: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = nn.ModuleList(
            _lecun_linear(hidden_size, hidden_size, generator) for _ in range(2))
        self.norm = nn.ModuleList(
            nn.LayerNorm(hidden_size, eps=1e-6) for _ in range(2) if use_layer_norm)
        self._act = parse_activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i, layer in enumerate(self.dense):
            if len(self.norm):
                y = self.norm[i](y)
            y = layer(self._act(y))
        return x + y


def _lecun_linear(in_features: int, out_features: int,
                  generator: Optional[torch.Generator]) -> nn.Linear:
    """flax's default Dense: LeCun normal kernel, zero bias."""
    layer = lecun_normal(nn.Linear(int(in_features), int(out_features)), generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class MLPResNetTorso(nn.Module):
    """Dense to `hidden_size`, then `num_blocks` MLP residual blocks."""

    def __init__(self, input_dim: int, num_blocks: int = 2, hidden_size: int = 256,
                 activation: str = "relu", use_layer_norm: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = nn.ModuleList([_lecun_linear(input_dim, hidden_size, generator)])
        self.blocks = nn.ModuleList(
            MLPResidualBlock(int(hidden_size), activation, use_layer_norm, generator)
            for _ in range(int(num_blocks)))
        self.output_dim = int(hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dense[0](x)
        for block in self.blocks:
            x = block(x)
        return x
