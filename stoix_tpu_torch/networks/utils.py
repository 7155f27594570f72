"""Activation and RNN-cell registries (counterpart of
stoix_tpu/networks/utils.py; flax's `normalise` activation is not ported,
and of the RNN cells only `gru` and `lstm` are)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from stoix_tpu_torch.networks.cells import GRUCell, LSTMCell


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


RNN_CELLS = {
    "gru": GRUCell,
    "lstm": LSTMCell,
}
# The JAX package's other cells (flax's OptimizedLSTMCell, MGUCell and
# SimpleCell), still to be ported (ROADMAP Queue A9).
UNPORTED_RNN_CELLS = ("optimised_lstm", "mgu", "simple")


def parse_rnn_cell(name: str) -> Callable:
    if name in UNPORTED_RNN_CELLS:
        raise ValueError(f"network.rnn_cell_type={name!r}: the {name} cell is not ported; "
                         f"ported: {sorted(RNN_CELLS)}")
    if name not in RNN_CELLS:
        raise ValueError(f"Unknown RNN cell '{name}'. Known: "
                         f"{sorted((*RNN_CELLS, *UNPORTED_RNN_CELLS))}")
    return RNN_CELLS[name]
