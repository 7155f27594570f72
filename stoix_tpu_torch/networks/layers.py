"""NoisyLinear, the factorised-Gaussian noisy layer of NoisyNets (counterpart
of stoix_tpu/networks/layers.py::NoisyLinear), and the helpers that draw its
noise.

    y = x (mu_w' + sigma_w . f(e_in) f(e_out)^T) + mu_b' + sigma_b . f(e_out),
    f(e) = sign(e) sqrt(|e|),

with e_in [in] and e_out [out] standard normal, drawn once a call and shared
by the whole batch. The parameters are stored as flax stores them: `mu_w`
[in, out] (NOT transposed, as it is not named `kernel`), `mu_b` [out], both
drawn uniform on [0, 2/sqrt(in)) and re-centred by -1/sqrt(in) in every
forward (mu_w' = mu_w - 1/sqrt(in)), and `sigma_w`, `sigma_b` initialised to
sigma_zero/sqrt(in). Keeping the stored values and the subtraction where
flax has them keeps an optimizer step on them bitwise flax's.

The noise is an explicit argument: `noise=(e_in, e_out)` for one layer, the
raw standard normals (f is applied here), or None for the noise-free forward
(mu only), which is what the JAX package's layer runs when no "noise" rng is
given (evaluation). A module holding several noisy layers takes the list of
their pairs in `noisy_layers` order; `draw_noise` makes that list from a
generator in ONE draw.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

Noise = Tuple[torch.Tensor, torch.Tensor]


def _factorised(e: torch.Tensor) -> torch.Tensor:
    return torch.sign(e) * torch.sqrt(torch.abs(e))


class NoisyLinear(nn.Module):
    def __init__(self, input_dim: int, features: int, sigma_zero: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.features = int(input_dim), int(features)
        # float32 throughout, as flax computes 1/sqrt(in) with jnp.
        root = np.sqrt(np.float32(self.in_features))
        bound = float(np.float32(1.0) / root)
        self.bound = bound
        sigma_init = float(np.float32(sigma_zero) / root)

        def uniform(*shape: int) -> nn.Parameter:
            return nn.Parameter(torch.rand(shape, generator=generator) * (2 * bound))

        self.mu_w = uniform(self.in_features, self.features)
        self.mu_b = uniform(self.features)
        self.sigma_w = nn.Parameter(torch.full((self.in_features, self.features), sigma_init))
        self.sigma_b = nn.Parameter(torch.full((self.features,), sigma_init))

    def forward(self, x: torch.Tensor, noise: Optional[Noise] = None) -> torch.Tensor:
        mu_w = self.mu_w - self.bound
        mu_b = self.mu_b - self.bound
        if noise is None:
            w, b = mu_w, mu_b
        else:
            eps_in, eps_out = (_factorised(e) for e in noise)
            w = mu_w + self.sigma_w * torch.outer(eps_in, eps_out)
            b = mu_b + self.sigma_b * eps_out
        return x @ w + b


def noisy_layers(module: nn.Module) -> List[NoisyLinear]:
    """The NoisyLinear layers under `module`, in registration order (the order
    their forwards run in every module here)."""
    return [m for m in module.modules() if isinstance(m, NoisyLinear)]


def draw_noise(module: nn.Module, generator: torch.Generator) -> List[Noise]:
    """One (e_in, e_out) pair of standard normals for each of `module`'s
    noisy layers, from one draw on the generator's device."""
    sizes = [size for layer in noisy_layers(module) for size in (layer.in_features,
                                                                  layer.features)]
    flat = torch.randn(sum(sizes), generator=generator, device=generator.device)
    parts = flat.split(sizes)
    return [(parts[i], parts[i + 1]) for i in range(0, len(parts), 2)]


def split_noise(noise: Optional[Sequence[Noise]], counts: Sequence[int]
                ) -> List[Optional[Sequence[Noise]]]:
    """A module's noise list cut into its children's shares (None stays None)."""
    if noise is None:
        return [None] * len(counts)
    out, start = [], 0
    for count in counts:
        out.append(noise[start:start + count])
        start += count
    return out
