"""Actor and critic compositions (counterpart of stoix_tpu/networks/base.py:
FeedForwardActor, FeedForwardCritic, FeedForwardActorCritic, MultiNetwork,
ScannedRNN, RecurrentActor and RecurrentCritic)."""

from __future__ import annotations

import inspect
from typing import Any, Optional, Sequence, Tuple

import torch
from torch import nn

from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.networks.utils import parse_rnn_cell
from stoix_tpu_torch.utils.tree import tree_map


class FeedForwardActor(nn.Module):
    """input -> torso -> action head, returning a distribution."""

    def __init__(self, action_head: nn.Module, torso: nn.Module, input_layer: nn.Module):
        super().__init__()
        self.action_head = action_head
        self.torso = torso
        self.input_layer = input_layer
        self._head_takes_mask = _head_takes_mask(action_head)

    def forward(self, observation: Any, *head_args: Any, **head_kwargs: Any) -> Any:
        """Extra arguments go to the head (a Q head's epsilon)."""
        embedding = self.torso(self.input_layer(observation))
        if isinstance(observation, Observation) and self._head_takes_mask:
            head_kwargs.setdefault("action_mask", observation.action_mask)
        return self.action_head(embedding, *head_args, **head_kwargs)


def _head_takes_mask(head: nn.Module) -> bool:
    return "action_mask" in inspect.signature(head.forward).parameters


class FeedForwardCritic(nn.Module):
    """input -> torso -> critic head, returning values. Extra inputs go to the
    input layer (a Q(s, a) critic's action)."""

    def __init__(self, critic_head: nn.Module, torso: nn.Module, input_layer: nn.Module):
        super().__init__()
        self.critic_head = critic_head
        self.torso = torso
        self.input_layer = input_layer

    def forward(self, observation: Any, *inputs: Any) -> Any:
        return self.critic_head(self.torso(self.input_layer(observation, *inputs)))


class FeedForwardActorCritic(nn.Module):
    """input -> torso -> a shared head (a PolicyValueHead), returning
    (distribution, value)."""

    def __init__(self, shared_head: nn.Module, torso: nn.Module, input_layer: nn.Module):
        super().__init__()
        self.shared_head = shared_head
        self.torso = torso
        self.input_layer = input_layer

    def forward(self, observation: Any) -> Tuple[Any, torch.Tensor]:
        return self.shared_head(self.torso(self.input_layer(observation)))


class MultiNetwork(nn.Module):
    """Networks run on the same inputs, their outputs stacked on a new last
    axis (twin Q critics); flax's `networks_i` are `networks.i`."""

    def __init__(self, networks: Sequence[nn.Module]):
        super().__init__()
        self.networks = nn.ModuleList(networks)

    def forward(self, *args: Any) -> torch.Tensor:
        return torch.stack([network(*args) for network in self.networks], dim=-1)


class ScannedRNN(nn.Module):
    """Time-major unroll of one cell: (hstate, (xs [T, B, F], dones [T, B]))
    -> (final hstate, outputs [T, B, H]). Where `done` is set at a step the
    carry is reset to the cell's fresh carry (zeros) BEFORE the cell runs,
    as the JAX package's nn.scan step does. The cell is `cell`, flax's
    `GRUCell_0` or `LSTMCell_0`."""

    def __init__(self, input_dim: int, hidden_size: int, cell_type: str = "gru",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size, self.cell_type = int(hidden_size), cell_type
        self.cell = parse_rnn_cell(cell_type)(input_dim, self.hidden_size, generator)
        self.output_dim = self.hidden_size

    def forward(self, hstate: Any, inputs: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[Any, torch.Tensor]:
        xs, dones = inputs
        outputs = []
        for x, done in zip(xs.unbind(0), dones.unbind(0)):
            keep = ~done.bool()[..., None]
            hstate = tree_map(lambda c: torch.where(keep, c, 0.0), hstate)
            hstate, out = self.cell(hstate, x)
            outputs.append(out)
        return hstate, torch.stack(outputs)

    @staticmethod
    def initialize_carry(cell_type: str, hidden_size: int, batch_shape: Sequence[int],
                         device: Optional[torch.device] = None) -> Any:
        """The cell's fresh carry for `batch_shape`: zeros [..., H] (a (c, h)
        pair for the LSTM)."""
        return parse_rnn_cell(cell_type).initialize_carry(hidden_size, batch_shape, device)


class RecurrentActor(nn.Module):
    """pre_torso -> RNN -> post_torso -> action head over a time-major
    sequence: (hstate, (observation [T, B, ...], done [T, B])) ->
    (hstate, distribution)."""

    def __init__(self, action_head: nn.Module, rnn: ScannedRNN, pre_torso: nn.Module,
                 post_torso: nn.Module, input_layer: nn.Module):
        super().__init__()
        self.action_head = action_head
        self.rnn = rnn
        self.pre_torso = pre_torso
        self.post_torso = post_torso
        self.input_layer = input_layer
        self._head_takes_mask = _head_takes_mask(action_head)

    def forward(self, hstate: Any, observation_done: Tuple[Any, torch.Tensor]) -> Tuple[Any, Any]:
        observation, done = observation_done
        x = self.pre_torso(self.input_layer(observation))
        hstate, x = self.rnn(hstate, (x, done))
        x = self.post_torso(x)
        kwargs = {}
        if isinstance(observation, Observation) and self._head_takes_mask:
            kwargs["action_mask"] = observation.action_mask
        return hstate, self.action_head(x, **kwargs)


class RecurrentCritic(nn.Module):
    """pre_torso -> RNN -> post_torso -> critic head: (hstate, (observation,
    done)) -> (hstate, values [T, B])."""

    def __init__(self, critic_head: nn.Module, rnn: ScannedRNN, pre_torso: nn.Module,
                 post_torso: nn.Module, input_layer: nn.Module):
        super().__init__()
        self.critic_head = critic_head
        self.rnn = rnn
        self.pre_torso = pre_torso
        self.post_torso = post_torso
        self.input_layer = input_layer

    def forward(self, hstate: Any, observation_done: Tuple[Any, torch.Tensor]) -> Tuple[Any, Any]:
        observation, done = observation_done
        x = self.pre_torso(self.input_layer(observation))
        hstate, x = self.rnn(hstate, (x, done))
        return hstate, self.critic_head(self.post_torso(x))
