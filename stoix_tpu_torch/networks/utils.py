"""Activation registry (counterpart of stoix_tpu/networks/utils.py; flax's
`normalise` entry is not ported)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


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
}


def parse_activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(name):
        return name
    if name not in ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'. Known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]
