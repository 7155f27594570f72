"""Input layers (counterpart of stoix_tpu/networks/inputs.py::ObservationInput)."""

from __future__ import annotations

import torch
from torch import nn

from stoix_tpu_torch.envs.types import Observation


class ObservationInput(nn.Module):
    """Select an attribute from the Observation struct (default: agent_view)."""

    def __init__(self, feature: str = "agent_view"):
        super().__init__()
        self.feature = feature

    def forward(self, observation: Observation) -> torch.Tensor:
        return getattr(observation, self.feature)
