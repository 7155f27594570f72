"""The Disco agent network (counterpart of stoix_tpu/networks/disco.py): a
shared torso, an action-conditioned LSTM transition and five heads.

ActionConditionedLSTMTorso keeps flax's names: the root MLP's `Dense_i`
(`dense.i`), `root_cell` and `action_lstm` (a `cells.LSTMCell`, each gate
under its flax name), so a carried flax tree maps one to one
(`utils/params.py`). DiscoAgentNetwork's members keep their attribute names
(`shared_torso`, `action_conditional_torso`, `logits_head`, `q_head`,
`y_head`, `z_head`, `aux_pi_head`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from stoix_tpu_torch.networks.cells import LSTMCell
from stoix_tpu_torch.networks.torso import init_linear
from stoix_tpu_torch.networks.utils import parse_activation_fn


class DiscoAgentOutput(NamedTuple):
    """The five prediction heads the Disco update rule reads."""

    logits: torch.Tensor  # [..., A] policy
    q: torch.Tensor  # [..., A, B] per-action categorical value
    y: torch.Tensor  # [..., B] state categorical prediction
    z: torch.Tensor  # [..., A, B] per-action auxiliary categorical
    aux_pi: torch.Tensor  # [..., A, A] per-action auxiliary policy


class ActionConditionedLSTMTorso(nn.Module):
    """The root embedding, then one LSTM step an action from the carry
    (tanh(root), root), every (state, action) pair as one row of a
    [batch . A] batch. Every leading dim is folded, so one unbatched
    observation's embedding works too."""

    def __init__(self, num_actions: int, input_dim: int, lstm_size: int = 256,
                 root_mlp_sizes: Sequence[int] = (), activation: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_actions = int(num_actions)
        self.output_dim = int(lstm_size)
        sizes = [int(input_dim)] + [int(s) for s in root_mlp_sizes]
        self.dense = nn.ModuleList(init_linear(nn.Linear(i, o), 1.0, generator)
                                   for i, o in zip(sizes[:-1], sizes[1:]))
        self.root_cell = init_linear(nn.Linear(sizes[-1], self.output_dim), 1.0, generator)
        self.action_lstm = LSTMCell(self.num_actions, self.output_dim, generator)
        self._act = parse_activation_fn(activation)

    def forward(self, embedding: torch.Tensor) -> torch.Tensor:
        lead = embedding.shape[:-1]
        x = embedding.reshape(-1, embedding.shape[-1])
        batch = x.shape[0]
        for layer in self.dense:
            x = self._act(layer(x))
        cell = self.root_cell(x)
        # flax's LSTM carry is (c, h): c = tanh(root), h = root.
        carry = tuple(c.repeat_interleave(self.num_actions, 0) for c in (torch.tanh(cell), cell))
        actions = torch.eye(self.num_actions, dtype=cell.dtype, device=cell.device).repeat(batch, 1)
        _, out = self.action_lstm(carry, actions)
        return out.reshape(tuple(lead) + (self.num_actions, self.output_dim))


class DiscoAgentNetwork(nn.Module):
    """The shared torso on the observation's `agent_view`; the logits and y
    heads on its embedding, the q, z and aux_pi heads on the
    action-conditioned embeddings."""

    def __init__(self, shared_torso: nn.Module, action_conditional_torso: nn.Module,
                 logits_head: nn.Module, q_head: nn.Module, y_head: nn.Module, z_head: nn.Module,
                 aux_pi_head: nn.Module):
        super().__init__()
        self.shared_torso = shared_torso
        self.action_conditional_torso = action_conditional_torso
        self.logits_head = logits_head
        self.q_head = q_head
        self.y_head = y_head
        self.z_head = z_head
        self.aux_pi_head = aux_pi_head

    def forward(self, observation) -> DiscoAgentOutput:
        embedding = self.shared_torso(observation.agent_view)
        per_action = self.action_conditional_torso(embedding)
        return DiscoAgentOutput(logits=self.logits_head(embedding), q=self.q_head(per_action),
                                y=self.y_head(embedding), z=self.z_head(per_action),
                                aux_pi=self.aux_pi_head(per_action))
