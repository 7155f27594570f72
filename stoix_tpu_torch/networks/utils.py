"""Activation and RNN-cell registries (counterpart of
stoix_tpu/networks/utils.py)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from stoix_tpu_torch.networks.cells import (
    GRUCell, LSTMCell, MGUCell, OptimizedLSTMCell, SimpleCell,
)


def standardize(x: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """flax's `standardize` over the last axis: (x - mean) . rsqrt(var + eps),
    the variance mean(x^2) - mean^2 clipped at 0, as flax computes it."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    variance = torch.clamp(torch.mean(torch.square(x), dim=-1, keepdim=True)
                           - torch.square(mean), min=0.0)
    return (x - mean) * torch.rsqrt(variance + epsilon)


ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "silu": F.silu,
    "swish": F.silu,
    "elu": F.elu,
    # flax's gelu defaults to the tanh approximation.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    # flax's leaky_relu slope is 0.01, as torch's default.
    "leaky_relu": F.leaky_relu,
    "identity": lambda x: x,
    "none": lambda x: x,
    "normalise": standardize,
}


def parse_activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(name):
        return name
    if name not in ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'. Known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


RNN_CELLS = {
    "lstm": LSTMCell,
    "optimised_lstm": OptimizedLSTMCell,
    "gru": GRUCell,
    "mgu": MGUCell,
    "simple": SimpleCell,
}


def parse_rnn_cell(name: str) -> Callable:
    if name not in RNN_CELLS:
        raise ValueError(f"Unknown RNN cell '{name}'. Known: {sorted(RNN_CELLS)}")
    return RNN_CELLS[name]
