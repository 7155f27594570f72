"""Distribution post-processors (counterpart of
stoix_tpu/networks/postprocessors.py): wrap a distribution's sample, mode and
mean with a transform WITHOUT correcting its log-prob (explicitly not a
bijector; simple action rescaling at act time), the rescaling functions, and
`min_max_normalize`, the world model's hidden-state normalisation."""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from stoix_tpu_torch.ops.distributions import Distribution


class PostProcessedDistribution(Distribution):
    def __init__(self, distribution: Distribution,
                 postprocessor: Callable[[torch.Tensor], torch.Tensor]):
        self.distribution = distribution
        self.postprocessor = postprocessor

    def sample(self, generator: Any = None, **kwargs: Any) -> torch.Tensor:
        return self.postprocessor(self.distribution.sample(generator, **kwargs))

    def mode(self) -> torch.Tensor:
        return self.postprocessor(self.distribution.mode())

    def mean(self) -> torch.Tensor:
        return self.postprocessor(self.distribution.mean())

    def __getattr__(self, name: str) -> Any:
        # Private and self-referential names are not delegated, so a copy
        # cannot recurse before `__dict__` exists.
        if name.startswith("_") or name == "distribution":
            raise AttributeError(name)
        return getattr(self.distribution, name)


def rescale_to_spec(x: torch.Tensor, minimum: Any, maximum: Any) -> torch.Tensor:
    """Affine map from [-1, 1] to [minimum, maximum]."""
    scale = (maximum - minimum) / 2.0
    offset = (maximum + minimum) / 2.0
    return x * scale + offset


def clip_to_spec(x: torch.Tensor, minimum: Any, maximum: Any) -> torch.Tensor:
    return torch.clamp(x, minimum, maximum)


def tanh_to_spec(x: torch.Tensor, minimum: Any, maximum: Any) -> torch.Tensor:
    return rescale_to_spec(torch.tanh(x), minimum, maximum)


def min_max_normalize(x: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """x rescaled to [0, 1] over its last axis: (x - min) / max(max - min, epsilon)."""
    x_min = x.amin(-1, keepdim=True)
    x_max = x.amax(-1, keepdim=True)
    return (x - x_min) / torch.clamp(x_max - x_min, min=epsilon)


class ScalePostProcessor(nn.Module):
    def __init__(self, minimum: Any, maximum: Any,
                 scale_fn: Callable[[torch.Tensor, Any, Any], torch.Tensor] = tanh_to_spec):
        super().__init__()
        self.minimum, self.maximum, self.scale_fn = minimum, maximum, scale_fn

    def forward(self, distribution: Distribution) -> PostProcessedDistribution:
        return PostProcessedDistribution(
            distribution, lambda x: self.scale_fn(x, self.minimum, self.maximum))
