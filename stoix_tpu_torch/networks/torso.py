"""Torso networks (counterpart of stoix_tpu/networks/torso.py::MLPTorso).

flax infers a Dense layer's input width at init; an `nn.Linear` needs it up
front, so every module here takes `input_dim` (`build_networks` passes it
from the env's observation spec) and exposes `output_dim` for the next module.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

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
