"""Network heads (counterpart of stoix_tpu/networks/heads.py,
CategoricalHead and ScalarCriticHead)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from stoix_tpu_torch.networks.torso import init_linear
from stoix_tpu_torch.ops.distributions import Categorical


class CategoricalHead(nn.Module):
    """Discrete policy head; applies the observation's action mask if given."""

    def __init__(
        self, num_actions: int, input_dim: int, generator: Optional[torch.Generator] = None
    ):
        super().__init__()
        self.dense = nn.ModuleList(
            [init_linear(nn.Linear(input_dim, num_actions), 0.01, generator)]
        )

    def forward(
        self, embedding: torch.Tensor, action_mask: Optional[torch.Tensor] = None
    ) -> Categorical:
        return Categorical(self.dense[0](embedding), mask=action_mask)


class ScalarCriticHead(nn.Module):
    def __init__(self, input_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = nn.ModuleList(
            [init_linear(nn.Linear(input_dim, 1), 1.0, generator)]
        )

    def forward(self, embedding: torch.Tensor) -> torch.Tensor:
        return self.dense[0](embedding)[..., 0]
