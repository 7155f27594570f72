"""Recurrent cells (counterpart of flax.linen's GRUCell, LSTMCell,
OptimizedLSTMCell, MGUCell and SimpleCell, which
stoix_tpu/networks/utils.py::RNN_CELLS names `gru`, `lstm`,
`optimised_lstm`, `mgu` and `simple`).

Each gate is its own Linear under flax's name, so a carried flax tree maps
one to one (`utils/params.py`): the GRU's `ir`, `iz`, `in` with a bias, `hr`
and `hz` without one, `hn` with one; the LSTM's (and the optimised LSTM's)
`ii`, `if`, `ig`, `io` without a bias and `hi`, `hf`, `hg`, `ho` with one;
the MGU's `if` and `in` with a bias, `hf` without one, `hn` with one; the
simple cell's `i` with a bias and `h` without one. Initialisation follows
flax's: input kernels LeCun normal (truncated), recurrent kernels
orthogonal, biases zero (the MGU's forget bias one). A fresh carry is zeros.

    cell(carry, x) -> (new_carry, output)
    Cell.initialize_carry(features, batch_shape, device) -> fresh carry
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated-normal variance scaling divides the stddev by this, the
# stddev of a standard normal truncated to [-2, 2].
_TRUNCATED_STDDEV = 0.87962566103423978


def lecun_normal(layer: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """flax's lecun_normal on a Linear's or a Conv2d's weight: fan-in is one
    output unit's weights (in, or in.kh.kw)."""
    std = math.sqrt(1.0 / layer.weight[0].numel()) / _TRUNCATED_STDDEV
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
    return layer


def _orthogonal(layer: nn.Linear, generator: Optional[torch.Generator]) -> nn.Linear:
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, generator=generator)
    return layer


class _GatedCell(nn.Module):
    """Named input (`i*`) and hidden (`h*`) Linears, one per gate."""

    def __init__(self, input_dim: int, features: int, gates: Sequence[str],
                 input_bias: bool, hidden_bias: Sequence[bool],
                 generator: Optional[torch.Generator]):
        super().__init__()
        for gate, h_bias in zip(gates, hidden_bias):
            i_layer = lecun_normal(nn.Linear(input_dim, features, bias=input_bias), generator)
            h_layer = _orthogonal(nn.Linear(features, features, bias=h_bias), generator)
            for layer in (i_layer, h_layer):
                if layer.bias is not None:
                    nn.init.zeros_(layer.bias)
            self.add_module("i" + gate, i_layer)
            self.add_module("h" + gate, h_layer)

    def gate(self, name: str, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self._modules["i" + name](x) + self._modules["h" + name](h)

    @staticmethod
    def initialize_carry(features: int, batch_shape: Sequence[int],
                         device: Optional[torch.device] = None) -> torch.Tensor:
        return torch.zeros(tuple(batch_shape) + (int(features),), device=device)


class GRUCell(_GatedCell):
    """r = σ(ir(x) + hr(h)), z = σ(iz(x) + hz(h)), n = tanh(in(x) + r·hn(h)),
    h' = (1 - z)·n + z·h."""

    def __init__(self, input_dim: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_dim, features, ("r", "z", "n"), True, (False, False, True),
                         generator)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        r = torch.sigmoid(self.gate("r", x, h))
        z = torch.sigmoid(self.gate("z", x, h))
        n = torch.tanh(self._modules["in"](x) + r * self._modules["hn"](h))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h


class LSTMCell(_GatedCell):
    """i, f, o = σ(·), g = tanh(·) of i*(x) + h*(h); c' = f·c + i·g,
    h' = o·tanh(c'); the carry is (c, h)."""

    def __init__(self, input_dim: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_dim, features, ("i", "f", "g", "o"), False, (True,) * 4,
                         generator)

    @staticmethod
    def initialize_carry(features: int, batch_shape: Sequence[int],
                         device: Optional[torch.device] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = tuple(batch_shape) + (int(features),)
        return torch.zeros(shape, device=device), torch.zeros(shape, device=device)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor],
                x: torch.Tensor) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        c, h = carry
        i = torch.sigmoid(self.gate("i", x, h))
        f = torch.sigmoid(self.gate("f", x, h))
        g = torch.tanh(self.gate("g", x, h))
        o = torch.sigmoid(self.gate("o", x, h))
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


class OptimizedLSTMCell(LSTMCell):
    """flax's OptimizedLSTMCell: the LSTM's gates and parameters, each side's
    four kernels applied as ONE product (the hidden side with its four
    biases) and split, then i, f, o = σ(h* + i*), g = tanh(h* + i*)."""

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor],
                x: torch.Tensor) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        c, h = carry
        gates = ("i", "f", "g", "o")
        hidden = F.linear(h, torch.cat([self._modules["h" + g].weight for g in gates]),
                          torch.cat([self._modules["h" + g].bias for g in gates]))
        inputs = F.linear(x, torch.cat([self._modules["i" + g].weight for g in gates]))
        (hi, hf, hg, ho), (ii, if_, ig, io) = hidden.chunk(4, -1), inputs.chunk(4, -1)
        i, f = torch.sigmoid(hi + ii), torch.sigmoid(hf + if_)
        g, o = torch.tanh(hg + ig), torch.sigmoid(ho + io)
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


class MGUCell(_GatedCell):
    """The minimal gated unit: f = σ(if(x) + hf(h)), n = tanh(in(x) + f·hn(h)),
    h' = (1 - f)·n + f·h."""

    def __init__(self, input_dim: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_dim, features, ("f", "n"), True, (False, True), generator)
        nn.init.ones_(self._modules["if"].bias)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        f = torch.sigmoid(self.gate("f", x, h))
        n = torch.tanh(self._modules["in"](x) + self._modules["hn"](h) * f)
        new_h = (1.0 - f) * n + f * h
        return new_h, new_h


class SimpleCell(_GatedCell):
    """h' = tanh(i(x) + h(h))."""

    def __init__(self, input_dim: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_dim, features, ("",), True, (False,), generator)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        new_h = torch.tanh(self.gate("", x, h))
        return new_h, new_h
