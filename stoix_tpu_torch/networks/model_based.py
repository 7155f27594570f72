"""World model of the MuZero family (counterpart of
stoix_tpu/networks/model_based.py::RewardBasedWorldModel), with the two
small modules the MuZero systems build beside it in the JAX package:
ActionOneHot (ff_mz's action embedder) and LatentPolicy (an MLP torso and a
policy head on the latent).

RewardBasedWorldModel: the observation encoder and `obs_to_hidden` give the
hidden state; a StackedRNN rolls it forward over embedded actions, with a
residual next state and min-max normalisation; the reward head reads the
dynamics' output. The RNN carries are packed into ONE flat vector between
steps (so the search tree stores one tensor a node), in flax's leaf order:
[c_0, h_0, c_1, h_1, ...] for LSTM cells, [h_0, h_1, ...] otherwise. The
policy and value heads read that vector.

`forward(method, *args)` runs `initial_state` or `step`, so one
`functional_call` with a parameter dict runs either.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stoix_tpu_torch.networks.cells import lecun_normal
from stoix_tpu_torch.networks.layers import StackedRNN
from stoix_tpu_torch.networks.postprocessors import min_max_normalize

_LSTMS = ("lstm", "optimised_lstm")


class RewardBasedWorldModel(nn.Module):
    """`obs_encoder`, `reward_head` and `action_embedder` are modules with
    an `output_dim` (the reward head reads `hidden_size`); flax's
    `obs_encoder`, `obs_to_hidden`, `dynamics/cells_i`, `reward_head` and
    `action_embedder` keep their names."""

    def __init__(self, obs_encoder: nn.Module, reward_head: nn.Module,
                 action_embedder: nn.Module, hidden_size: int = 256, num_rnn_layers: int = 2,
                 rnn_cell_type: str = "lstm", normalize_hidden: bool = True,
                 generator: Any = None):
        super().__init__()
        self.obs_encoder = obs_encoder
        self.reward_head = reward_head
        self.action_embedder = action_embedder
        self.hidden_size, self.num_rnn_layers = int(hidden_size), int(num_rnn_layers)
        self.rnn_cell_type, self.normalize_hidden = str(rnn_cell_type), bool(normalize_hidden)
        self.dynamics = StackedRNN(action_embedder.output_dim, self.hidden_size,
                                   self.num_rnn_layers, self.rnn_cell_type, generator)
        self.obs_to_hidden = lecun_normal(nn.Linear(obs_encoder.output_dim, self.hidden_size),
                                          generator)
        nn.init.zeros_(self.obs_to_hidden.bias)
        per_layer = 2 if self.rnn_cell_type in _LSTMS else 1
        self.latent_dim = self.num_rnn_layers * per_layer * self.hidden_size

    def pack_state(self, states: Tuple[Any, ...]) -> torch.Tensor:
        leaves = [leaf for state in states
                  for leaf in (state if isinstance(state, tuple) else (state,))]
        return torch.cat(leaves, dim=-1)

    def unpack_state(self, flat: torch.Tensor) -> Tuple[Any, ...]:
        chunks = flat.split(self.hidden_size, dim=-1)
        if self.rnn_cell_type in _LSTMS:
            return tuple((chunks[2 * i], chunks[2 * i + 1]) for i in range(self.num_rnn_layers))
        return tuple(chunks)

    def initial_state(self, observation: torch.Tensor) -> torch.Tensor:
        """The flat hidden state of an observation: every layer's hidden
        output seeded with the embedding's projection (LSTM cells zero)."""
        proj = self.obs_to_hidden(self.obs_encoder(observation))
        if self.rnn_cell_type in _LSTMS:
            carry = tuple((torch.zeros_like(proj), proj) for _ in range(self.num_rnn_layers))
        else:
            carry = tuple(proj for _ in range(self.num_rnn_layers))
        flat = self.pack_state(carry)
        return min_max_normalize(flat) if self.normalize_hidden else flat

    def step(self, flat_state: torch.Tensor, action: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One latent step: (next flat state, reward logits)."""
        new_states, out = self.dynamics(self.unpack_state(flat_state),
                                        self.action_embedder(action))
        new_flat = self.pack_state(new_states) + flat_state
        if self.normalize_hidden:
            new_flat = min_max_normalize(new_flat)
        return new_flat, self.reward_head(out)

    def forward(self, method: str, *args: Any) -> Any:
        return getattr(self, method)(*args)


class ActionOneHot(nn.Module):
    """A discrete action as a float32 one-hot; no parameters."""

    def __init__(self, num_actions: int):
        super().__init__()
        self.output_dim = int(num_actions)

    def forward(self, action: torch.Tensor) -> torch.Tensor:
        return F.one_hot(action.long(), self.output_dim).to(torch.float32)


class LatentPolicy(nn.Module):
    """A policy on the latent: an MLP torso (flax's `MLPTorso_0`,
    `torsos.0`), then a distribution head (`action_head`)."""

    def __init__(self, torso: nn.Module, action_head: nn.Module):
        super().__init__()
        self.torsos = nn.ModuleList([torso])
        self.action_head = action_head

    def forward(self, latent: torch.Tensor) -> Any:
        return self.action_head(self.torsos[0](latent))
