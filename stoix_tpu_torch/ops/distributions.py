"""Categorical policy distribution and the value-based family's
epsilon-greedy and greedy distributions over Q-values (counterpart of
stoix_tpu/ops/distributions.py::Categorical, EpsilonGreedy, Greedy).

    d.sample(generator)   d.log_prob(x)   d.entropy()   d.mode()   d.kl_divergence(q)

Sampling is Gumbel-max, as `jax.random.categorical`; it draws from an
explicit `torch.Generator` on the logits' device.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F


class Categorical:
    """Categorical over the last axis of `logits`, with an optional action mask."""

    def __init__(self, logits: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if mask is not None:
            logits = torch.where(mask > 0, logits, torch.finfo(logits.dtype).min)
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    @property
    def probs(self) -> torch.Tensor:
        return torch.exp(self.logits)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        tiny = torch.finfo(self.logits.dtype).tiny
        u = torch.rand(
            self.logits.shape, generator=generator, device=self.logits.device,
            dtype=self.logits.dtype,
        ).clamp_(min=tiny)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(self.logits + gumbel, dim=-1)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return torch.gather(self.logits, -1, value.long().unsqueeze(-1)).squeeze(-1)

    def entropy(self) -> torch.Tensor:
        p = self.probs
        return -torch.sum(p * torch.where(p > 0, self.logits, 0.0), dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    def kl_divergence(self, other: "Categorical") -> torch.Tensor:
        """KL(self || other) over the last axis."""
        p = self.probs
        return torch.sum(p * torch.where(p > 0, self.logits - other.logits, 0.0), dim=-1)


def _mask_preferences(preferences: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return preferences
    return torch.where(mask > 0, preferences, torch.finfo(preferences.dtype).min)


class EpsilonGreedy(Categorical):
    """Epsilon-greedy over Q-values, as the JAX package's: probabilities
    (1 - eps) . onehot(argmax) + eps . uniform, logits log(probs + 1e-12).
    With a mask the argmax is over legal actions and the eps mass is spread
    over them. `epsilon` is a float or a scalar tensor; it enters in the
    preferences' dtype, as JAX's weakly typed scalar does. `torch.argmax`
    takes the first maximum, as `jnp.argmax` does."""

    def __init__(self, preferences: torch.Tensor, epsilon: Union[float, torch.Tensor],
                 mask: Optional[torch.Tensor] = None):
        self.preferences = preferences
        self.epsilon = epsilon
        num = preferences.shape[-1]
        masked = _mask_preferences(preferences, mask)
        self._masked_preferences = masked
        greedy = F.one_hot(torch.argmax(masked, dim=-1), num).to(preferences.dtype)
        if mask is None:
            uniform = torch.ones_like(preferences) / num
        else:
            valid = (mask > 0).to(preferences.dtype)
            uniform = valid / valid.sum(dim=-1, keepdim=True)
        eps = torch.as_tensor(epsilon, dtype=preferences.dtype, device=preferences.device)
        probs = (1.0 - eps) * greedy + eps * uniform
        super().__init__(torch.log(probs + 1e-12), mask=mask)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self._masked_preferences, dim=-1)


class Greedy(Categorical):
    def __init__(self, preferences: torch.Tensor, mask: Optional[torch.Tensor] = None):
        self.preferences = preferences
        masked = _mask_preferences(preferences, mask)
        self._masked_preferences = masked
        probs = F.one_hot(torch.argmax(masked, dim=-1), preferences.shape[-1]).to(
            preferences.dtype)
        super().__init__(torch.log(probs + 1e-12), mask=mask)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self._masked_preferences, dim=-1)
