"""Network heads (counterpart of stoix_tpu/networks/heads.py:
CategoricalHead, ScalarCriticHead and the value-based family's
DiscreteQNetworkHead, DistributionalDiscreteQNetwork and
QuantileDiscreteQNetwork).

The distributional heads are one Dense of A.M (C51) or N.A (QR-DQN) outputs
reshaped to [..., A, M] or [..., N, A] in row-major order, as flax reshapes
them, so carried-across weights mean the same thing."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from stoix_tpu_torch.networks.torso import init_linear
from stoix_tpu_torch.ops.distributions import Categorical, EpsilonGreedy

Epsilon = Union[float, torch.Tensor, None]


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


class DiscreteQNetworkHead(nn.Module):
    """Q-values head returning an EpsilonGreedy distribution, so value-based
    acting is `dist.sample(generator)` as policy-based acting is."""

    def __init__(self, action_dim: int, input_dim: int, epsilon: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.dense = nn.ModuleList([init_linear(nn.Linear(input_dim, action_dim), 1.0, generator)])

    def forward(self, embedding: torch.Tensor, epsilon: Epsilon = None,
                action_mask: Optional[torch.Tensor] = None) -> EpsilonGreedy:
        eps = self.epsilon if epsilon is None else epsilon
        return EpsilonGreedy(self.dense[0](embedding), eps, mask=action_mask)


class DistributionalDiscreteQNetwork(nn.Module):
    """C51 head: (epsilon-greedy over the mean Q, atom logits [..., A, M],
    atoms [M])."""

    def __init__(self, action_dim: int, input_dim: int, num_atoms: int = 51,
                 vmin: float = -10.0, vmax: float = 10.0, epsilon: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.action_dim, self.num_atoms = int(action_dim), int(num_atoms)
        self.vmin, self.vmax, self.epsilon = float(vmin), float(vmax), float(epsilon)
        self.dense = nn.ModuleList(
            [init_linear(nn.Linear(input_dim, self.action_dim * self.num_atoms), 1.0, generator)])

    def forward(self, embedding: torch.Tensor, epsilon: Epsilon = None,
                action_mask: Optional[torch.Tensor] = None
                ) -> Tuple[EpsilonGreedy, torch.Tensor, torch.Tensor]:
        atoms = torch.linspace(self.vmin, self.vmax, self.num_atoms, device=embedding.device)
        logits = self.dense[0](embedding).reshape(
            embedding.shape[:-1] + (self.action_dim, self.num_atoms))
        q_values = torch.sum(torch.softmax(logits, dim=-1) * atoms, dim=-1)
        eps = self.epsilon if epsilon is None else epsilon
        return EpsilonGreedy(q_values, eps, mask=action_mask), logits, atoms


class QuantileDiscreteQNetwork(nn.Module):
    """QR-DQN head: (epsilon-greedy over the mean Q, quantiles [..., N, A],
    taus [..., N])."""

    def __init__(self, action_dim: int, input_dim: int, num_quantiles: int = 51,
                 epsilon: float = 0.1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.action_dim, self.num_quantiles = int(action_dim), int(num_quantiles)
        self.epsilon = float(epsilon)
        self.dense = nn.ModuleList([init_linear(
            nn.Linear(input_dim, self.action_dim * self.num_quantiles), 1.0, generator)])

    def forward(self, embedding: torch.Tensor, epsilon: Epsilon = None,
                action_mask: Optional[torch.Tensor] = None
                ) -> Tuple[EpsilonGreedy, torch.Tensor, torch.Tensor]:
        q_dist = self.dense[0](embedding).reshape(
            embedding.shape[:-1] + (self.num_quantiles, self.action_dim))
        q_values = torch.mean(q_dist, dim=-2)
        tau = (torch.arange(self.num_quantiles, device=embedding.device) + 0.5) / self.num_quantiles
        tau = torch.broadcast_to(tau, embedding.shape[:-1] + (self.num_quantiles,))
        eps = self.epsilon if epsilon is None else epsilon
        return EpsilonGreedy(q_values, eps, mask=action_mask), q_dist, tau
