"""Categorical policy distribution (counterpart of
stoix_tpu/ops/distributions.py::Categorical).

    d.sample(generator)   d.log_prob(x)   d.entropy()   d.mode()   d.kl_divergence(q)

Sampling is Gumbel-max, as `jax.random.categorical`; it draws from an
explicit `torch.Generator` on the logits' device.
"""

from __future__ import annotations

from typing import Optional

import torch


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
