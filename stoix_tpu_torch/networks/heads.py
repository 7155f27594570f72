"""Network heads (counterpart of stoix_tpu/networks/heads.py:
CategoricalHead, ScalarCriticHead, the continuous family's
NormalAffineTanhDistributionHead, BetaDistributionHead and
MultivariateNormalDiagHead, the deterministic policy's DeterministicHead,
the shared-torso PolicyValueHead, the value-based family's
DiscreteQNetworkHead, DistributionalDiscreteQNetwork and
QuantileDiscreteQNetwork, D4PG's DistributionalContinuousQNetwork, the
MuZero family's MLPLogitsHead, and the raw LinearHead of the Disco agent).

A continuous head is two Denses, flax's Dense_0 (the loc, or alpha) and
Dense_1 (the scale, or beta), as `dense.0` and `dense.1`; its `minimum` and
`maximum` come from the env's Box (`systems/anakin.py::head_kwargs_for_env`).

The distributional heads are one Dense of A.M (C51) or N.A (QR-DQN) outputs
reshaped to [..., A, M] or [..., N, A] in row-major order, as flax reshapes
them, so carried-across weights mean the same thing."""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch
from torch import nn

from stoix_tpu_torch.networks.cells import lecun_normal
from stoix_tpu_torch.networks.torso import MLPTorso, init_linear
from stoix_tpu_torch.ops.distributions import (
    AffineBeta,
    Categorical,
    Deterministic,
    EpsilonGreedy,
    Independent,
    MultivariateNormalDiag,
    TanhNormal,
    softplus,
)

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


def _set_bounds(head: nn.Module, minimum: Any, maximum: Any) -> None:
    """A number stays a float; a per-dimension bound is a buffer, so it moves
    with the head to its device once, not at every forward."""
    for name, value in (("minimum", minimum), ("maximum", maximum)):
        if isinstance(value, (int, float)):
            setattr(head, name, float(value))
        else:
            head.register_buffer(name, torch.as_tensor(value, dtype=torch.float32),
                                 persistent=False)


def _two_denses(input_dim: int, action_dim: int,
                generator: Optional[torch.Generator]) -> nn.ModuleList:
    return nn.ModuleList(
        [init_linear(nn.Linear(input_dim, action_dim), 0.01, generator) for _ in range(2)])


class NormalAffineTanhDistributionHead(nn.Module):
    """Squashed-Gaussian policy on [minimum, maximum]: loc from Dense_0, scale
    softplus(Dense_1) + min_scale."""

    def __init__(self, action_dim: int, input_dim: int, minimum: Any = -1.0,
                 maximum: Any = 1.0, min_scale: float = 1e-3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _set_bounds(self, minimum, maximum)
        self.min_scale = float(min_scale)
        self.dense = _two_denses(input_dim, action_dim, generator)

    def forward(self, embedding: torch.Tensor) -> Independent:
        loc = self.dense[0](embedding)
        scale = softplus(self.dense[1](embedding)) + self.min_scale
        return Independent(TanhNormal(loc, scale, self.minimum, self.maximum), 1)


class BetaDistributionHead(nn.Module):
    """Beta policy on [minimum, maximum]; softplus(.) + 1 keeps alpha and
    beta above 1 (unimodal)."""

    def __init__(self, action_dim: int, input_dim: int, minimum: Any = -1.0,
                 maximum: Any = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        _set_bounds(self, minimum, maximum)
        self.dense = _two_denses(input_dim, action_dim, generator)

    def forward(self, embedding: torch.Tensor) -> AffineBeta:
        alpha = softplus(self.dense[0](embedding)) + 1.0
        beta = softplus(self.dense[1](embedding)) + 1.0
        return AffineBeta(alpha, beta, self.minimum, self.maximum)


class MultivariateNormalDiagHead(nn.Module):
    """Unsquashed diagonal Gaussian: scale softplus(Dense_1) . init_scale /
    softplus(0), plus min_scale."""

    def __init__(self, action_dim: int, input_dim: int, init_scale: float = 0.3,
                 min_scale: float = 1e-6, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.init_scale, self.min_scale = float(init_scale), float(min_scale)
        self.dense = _two_denses(input_dim, action_dim, generator)

    def forward(self, embedding: torch.Tensor) -> MultivariateNormalDiag:
        loc = self.dense[0](embedding)
        raw_scale = self.dense[1](embedding)
        scale = softplus(raw_scale) * self.init_scale / softplus(raw_scale.new_zeros(()))
        return MultivariateNormalDiag(loc, scale + self.min_scale)


class DeterministicHead(nn.Module):
    """Deterministic policy (DDPG, TD3): tanh(Dense_0) scaled to [minimum,
    maximum] by the host floats half_width and mid, as flax forms them."""

    def __init__(self, action_dim: int, input_dim: int, minimum: float = -1.0,
                 maximum: float = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.half_width = (float(maximum) - float(minimum)) / 2.0
        self.mid = (float(maximum) + float(minimum)) / 2.0
        self.dense = nn.ModuleList([init_linear(nn.Linear(input_dim, action_dim), 0.01, generator)])

    def forward(self, embedding: torch.Tensor) -> Deterministic:
        return Deterministic(torch.tanh(self.dense[0](embedding)) * self.half_width + self.mid)


class ScalarCriticHead(nn.Module):
    def __init__(self, input_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = nn.ModuleList(
            [init_linear(nn.Linear(input_dim, 1), 1.0, generator)]
        )

    def forward(self, embedding: torch.Tensor) -> torch.Tensor:
        return self.dense[0](embedding)[..., 0]


class PolicyValueHead(nn.Module):
    """A shared torso's policy and scalar value (Sebulba IMPALA's shared
    torso): (the action head's distribution, the critic head's value)."""

    def __init__(self, action_head: nn.Module, critic_head: nn.Module):
        super().__init__()
        self.action_head = action_head
        self.critic_head = critic_head

    def forward(self, embedding: torch.Tensor, *args: Any,
                **kwargs: Any) -> Tuple[Any, torch.Tensor]:
        return self.action_head(embedding, *args, **kwargs), self.critic_head(embedding)


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


class DistributionalContinuousQNetwork(nn.Module):
    """D4PG critic head: (expected Q [...], atom logits [..., M], atoms [M])
    over the fixed support linspace(vmin, vmax, M). The support is
    `torch.linspace`'s, within one float32 ulp of every `jnp.linspace` (XLA
    itself rounds it apart eagerly, compiled and constant-folded: ROADMAP
    C17)."""

    def __init__(self, input_dim: int, num_atoms: int = 51, vmin: float = -10.0,
                 vmax: float = 10.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_atoms, self.vmin, self.vmax = int(num_atoms), float(vmin), float(vmax)
        self.dense = nn.ModuleList([init_linear(nn.Linear(input_dim, self.num_atoms), 1.0,
                                                generator)])

    def forward(self, embedding: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        atoms = torch.linspace(self.vmin, self.vmax, self.num_atoms, device=embedding.device)
        logits = self.dense[0](embedding)
        q_value = torch.sum(torch.softmax(logits, dim=-1) * atoms, dim=-1)
        return q_value, logits, atoms


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


class MLPLogitsHead(nn.Module):
    """An MLP torso, then raw logits: MuZero's 601-atom value and reward
    heads over a transformed support (decoded by
    ops/value_transforms.py::muzero_pair, never softmaxed here). flax's
    `MLPTorso_0` and `Dense_0` (`torsos.0`, `dense.0`); the logits layer
    takes flax's default init (LeCun normal, zero bias)."""

    def __init__(self, num_outputs: int, input_dim: int, hidden_sizes: Tuple[int, ...] = (64,),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        torso = MLPTorso(input_dim, tuple(hidden_sizes), generator=generator)
        self.torsos = nn.ModuleList([torso])
        linear = lecun_normal(nn.Linear(torso.output_dim, int(num_outputs)), generator)
        nn.init.zeros_(linear.bias)
        self.dense = nn.ModuleList([linear])
        self.output_dim = int(num_outputs)

    def forward(self, embedding: torch.Tensor) -> torch.Tensor:
        return self.dense[0](self.torsos[0](embedding))


class LinearHead(nn.Module):
    """A raw linear projection, flax's `Dense_0` (`dense.0`, orthogonal
    init of gain 1, zero bias), its last axis squeezed when `output_dim` is 1
    (the Disco agent's five heads)."""

    def __init__(self, output_dim: int, input_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.output_dim = int(output_dim)
        self.dense = nn.ModuleList([init_linear(nn.Linear(input_dim, self.output_dim), 1.0,
                                                generator)])

    def forward(self, embedding: torch.Tensor) -> torch.Tensor:
        out = self.dense[0](embedding)
        return out[..., 0] if self.output_dim == 1 else out
