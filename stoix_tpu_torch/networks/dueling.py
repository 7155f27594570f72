"""Dueling Q-network heads (counterpart of stoix_tpu/networks/dueling.py):
DuelingQNetwork, DistributionalDuelingQNetwork and Rainbow's
NoisyDistributionalDuelingQNetwork.

Each head is two torsos over the embedding, flax's MLPTorso_0 (or
NoisyMLPTorso_0), the value stream, and MLPTorso_1 (NoisyMLPTorso_1), the
advantage stream, as `torsos.0` and `torsos.1`:

    Q = V + A - mean_a A,

over atoms for the distributional heads (the advantage's A.M outputs
reshaped to [..., A, M] in flax's row-major order), whose Q values are the
softmax expectation over the atom support. The noisy head takes its layers'
noise as `noise` (networks/layers.py; None runs the noise-free forward).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from stoix_tpu_torch.networks.layers import Noise, noisy_layers, split_noise
from stoix_tpu_torch.networks.torso import MLPTorso, NoisyMLPTorso
from stoix_tpu_torch.ops.distributions import EpsilonGreedy

Epsilon = Union[float, torch.Tensor, None]


def _dueling(value: torch.Tensor, advantage: torch.Tensor, axis: int) -> torch.Tensor:
    return value + advantage - torch.mean(advantage, dim=axis, keepdim=True)


class DuelingQNetwork(nn.Module):
    """Q(s, a) = V(s) + A(s, a) - mean_a A(s, a), epsilon-greedy."""

    def __init__(self, action_dim: int, input_dim: int, epsilon: float = 0.1,
                 layer_sizes: Sequence[int] = (128,), activation: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.epsilon = float(epsilon)
        sizes = tuple(int(s) for s in layer_sizes)
        self.torsos = nn.ModuleList([
            MLPTorso(input_dim, (*sizes, width), activation, activate_final=False,
                     generator=generator)
            for width in (1, int(action_dim))])

    def forward(self, embedding: torch.Tensor, epsilon: Epsilon = None,
                action_mask: Optional[torch.Tensor] = None) -> EpsilonGreedy:
        value, advantage = (torso(embedding) for torso in self.torsos)
        eps = self.epsilon if epsilon is None else epsilon
        return EpsilonGreedy(_dueling(value, advantage, -1), eps, mask=action_mask)


class _DistributionalDueling(nn.Module):
    """The two distributional dueling heads' shared forward. The atom
    support is a buffer, made once and moved with the head."""

    def _setup(self, action_dim: int, num_atoms: int, vmin: float, vmax: float,
               epsilon: float) -> None:
        self.action_dim, self.num_atoms = int(action_dim), int(num_atoms)
        self.epsilon = float(epsilon)
        self.register_buffer("atoms", torch.linspace(float(vmin), float(vmax), self.num_atoms),
                             persistent=False)

    def _head(self, embedding: torch.Tensor, value: torch.Tensor, advantage: torch.Tensor,
              epsilon: Epsilon, action_mask: Optional[torch.Tensor]
              ) -> Tuple[EpsilonGreedy, torch.Tensor, torch.Tensor]:
        atoms = self.atoms
        advantage = advantage.reshape(embedding.shape[:-1] + (self.action_dim, self.num_atoms))
        logits = _dueling(value[..., None, :], advantage, -2)
        q_values = torch.sum(torch.softmax(logits, dim=-1) * atoms, dim=-1)
        eps = self.epsilon if epsilon is None else epsilon
        return EpsilonGreedy(q_values, eps, mask=action_mask), logits, atoms


class DistributionalDuelingQNetwork(_DistributionalDueling):
    """Dueling C51: value and advantage atoms combined, then softmaxed:
    (epsilon-greedy over the mean Q, logits [..., A, M], atoms [M])."""

    def __init__(self, action_dim: int, input_dim: int, num_atoms: int = 51,
                 vmin: float = -10.0, vmax: float = 10.0, epsilon: float = 0.1,
                 layer_sizes: Sequence[int] = (128,), activation: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._setup(action_dim, num_atoms, vmin, vmax, epsilon)
        sizes = tuple(int(s) for s in layer_sizes)
        self.torsos = nn.ModuleList([
            MLPTorso(input_dim, (*sizes, width), activation, activate_final=False,
                     generator=generator)
            for width in (self.num_atoms, self.action_dim * self.num_atoms)])

    def forward(self, embedding: torch.Tensor, epsilon: Epsilon = None,
                action_mask: Optional[torch.Tensor] = None
                ) -> Tuple[EpsilonGreedy, torch.Tensor, torch.Tensor]:
        value, advantage = (torso(embedding) for torso in self.torsos)
        return self._head(embedding, value, advantage, epsilon, action_mask)


class NoisyDistributionalDuelingQNetwork(_DistributionalDueling):
    """Rainbow's head: noisy layers, dueling, C51. Training passes `noise`
    (one pair a noisy layer, the value stream's first); evaluation passes
    none and runs the means only."""

    def __init__(self, action_dim: int, input_dim: int, num_atoms: int = 51,
                 vmin: float = -10.0, vmax: float = 10.0, epsilon: float = 0.0,
                 layer_sizes: Sequence[int] = (128,), activation: str = "relu",
                 sigma_zero: float = 0.5, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._setup(action_dim, num_atoms, vmin, vmax, epsilon)
        sizes = tuple(int(s) for s in layer_sizes)
        self.torsos = nn.ModuleList([
            NoisyMLPTorso(input_dim, (*sizes, width), activation, activate_final=False,
                          sigma_zero=sigma_zero, generator=generator)
            for width in (self.num_atoms, self.action_dim * self.num_atoms)])
        self._noise_counts = [len(noisy_layers(torso)) for torso in self.torsos]

    def forward(self, embedding: torch.Tensor, epsilon: Epsilon = None,
                action_mask: Optional[torch.Tensor] = None,
                noise: Optional[Sequence[Noise]] = None
                ) -> Tuple[EpsilonGreedy, torch.Tensor, torch.Tensor]:
        shares = split_noise(noise, self._noise_counts)
        value, advantage = (torso(embedding, share) for torso, share in zip(self.torsos, shares))
        return self._head(embedding, value, advantage, epsilon, action_mask)
