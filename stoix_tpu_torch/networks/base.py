"""Actor and critic compositions (counterpart of stoix_tpu/networks/base.py,
FeedForwardActor and FeedForwardCritic)."""

from __future__ import annotations

import inspect
from typing import Any

from torch import nn

from stoix_tpu_torch.envs.types import Observation


class FeedForwardActor(nn.Module):
    """input -> torso -> action head, returning a distribution."""

    def __init__(self, action_head: nn.Module, torso: nn.Module, input_layer: nn.Module):
        super().__init__()
        self.action_head = action_head
        self.torso = torso
        self.input_layer = input_layer
        self._head_takes_mask = "action_mask" in inspect.signature(action_head.forward).parameters

    def forward(self, observation: Any, *head_args: Any, **head_kwargs: Any) -> Any:
        """Extra arguments go to the head (a Q head's epsilon)."""
        embedding = self.torso(self.input_layer(observation))
        if isinstance(observation, Observation) and self._head_takes_mask:
            head_kwargs.setdefault("action_mask", observation.action_mask)
        return self.action_head(embedding, *head_args, **head_kwargs)


class FeedForwardCritic(nn.Module):
    """input -> torso -> critic head, returning values."""

    def __init__(self, critic_head: nn.Module, torso: nn.Module, input_layer: nn.Module):
        super().__init__()
        self.critic_head = critic_head
        self.torso = torso
        self.input_layer = input_layer

    def forward(self, observation: Any) -> Any:
        return self.critic_head(self.torso(self.input_layer(observation)))
