"""Policy distributions (counterpart of stoix_tpu/ops/distributions.py):
the Categorical policy, the value-based family's epsilon-greedy and greedy
distributions over Q-values, the continuous family's Normal,
Independent, MultivariateNormalDiag, TanhNormal, Beta and AffineBeta, and
the deterministic policy's point mass, Deterministic.

    d.sample(generator)   d.sample_and_log_prob(generator)   d.log_prob(x)
    d.entropy()   d.mode()   d.mean()   d.stddev()   d.kl_divergence(q)

Every draw comes from an explicit `torch.Generator` on the parameters'
device; the Gaussian family also takes its standard-normal `noise` directly,
so a test can hand both packages the same draw. Categorical sampling is
Gumbel-max, as `jax.random.categorical`; Beta draws two standard gammas.
A method the JAX class lacks raises as it does there: `kl_divergence` of
TanhNormal and Beta (and so of the Independent and AffineBeta around them)
raises NotImplementedError, and `stddev` exists only on the Gaussians.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, log(1 + e^x) as logaddexp(x, 0) at every x
    (`F.softplus` returns x itself past its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class Distribution:
    """The interface; a method a distribution does not define raises
    NotImplementedError, as the JAX package's base class does."""

    def sample(self, generator: Optional[torch.Generator] = None, **kwargs: Any) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def entropy(self) -> torch.Tensor:
        raise NotImplementedError

    def mode(self) -> torch.Tensor:
        raise NotImplementedError

    def mean(self) -> torch.Tensor:
        raise NotImplementedError

    def sample_and_log_prob(
        self, generator: Optional[torch.Generator] = None, **kwargs: Any
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.sample(generator, **kwargs)
        return x, self.log_prob(x)

    def kl_divergence(self, other: "Distribution") -> torch.Tensor:
        raise NotImplementedError


class Categorical(Distribution):
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


class Normal(Distribution):
    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    def sample(self, generator: Optional[torch.Generator] = None, *,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """loc + scale . noise, the noise standard normal from `generator`
        unless given."""
        if noise is None:
            noise = torch.randn(self.loc.shape, generator=generator, device=self.loc.device,
                                dtype=self.loc.dtype)
        return self.loc + self.scale * noise

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        z = (value - self.loc) / self.scale
        return -0.5 * z**2 - torch.log(self.scale) - _HALF_LOG_2PI

    def entropy(self) -> torch.Tensor:
        return 0.5 + _HALF_LOG_2PI + torch.log(self.scale)

    def mode(self) -> torch.Tensor:
        return self.loc

    def mean(self) -> torch.Tensor:
        return self.loc

    def stddev(self) -> torch.Tensor:
        return self.scale

    def kl_divergence(self, other: "Normal") -> torch.Tensor:
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


class Independent(Distribution):
    """Sums log_prob, entropy and kl over the last `reinterpreted_batch_ndims`
    axes; sampling, mode, mean and stddev are the inner distribution's."""

    def __init__(self, distribution: Distribution, reinterpreted_batch_ndims: int = 1):
        self.distribution = distribution
        self._ndims = int(reinterpreted_batch_ndims)

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x, dim=tuple(range(-self._ndims, 0)))

    def sample(self, generator: Optional[torch.Generator] = None, **kwargs: Any) -> torch.Tensor:
        return self.distribution.sample(generator, **kwargs)

    def sample_and_log_prob(
        self, generator: Optional[torch.Generator] = None, **kwargs: Any
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        x, lp = self.distribution.sample_and_log_prob(generator, **kwargs)
        return x, self._reduce(lp)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return self._reduce(self.distribution.log_prob(value))

    def entropy(self) -> torch.Tensor:
        return self._reduce(self.distribution.entropy())

    def mode(self) -> torch.Tensor:
        return self.distribution.mode()

    def mean(self) -> torch.Tensor:
        return self.distribution.mean()

    def stddev(self) -> torch.Tensor:
        return self.distribution.stddev()

    def kl_divergence(self, other: "Independent") -> torch.Tensor:
        return self._reduce(self.distribution.kl_divergence(other.distribution))


class MultivariateNormalDiag(Independent):
    def __init__(self, loc: torch.Tensor, scale_diag: torch.Tensor):
        super().__init__(Normal(loc, scale_diag), 1)
        self.loc = loc
        self.scale_diag = scale_diag


class Deterministic(Distribution):
    """A point mass at `loc` (DDPG, TD3): `sample` draws nothing and returns
    `loc`; `log_prob` and `entropy` are zeros over `loc.shape[:-1]`."""

    def __init__(self, loc: torch.Tensor):
        self.loc = loc

    def sample(self, generator: Optional[torch.Generator] = None, **kwargs: Any) -> torch.Tensor:
        return self.loc

    def _zeros(self) -> torch.Tensor:
        return self.loc.new_zeros(self.loc.shape[:-1] if self.loc.dim() else ())

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return self._zeros()

    def entropy(self) -> torch.Tensor:
        return self._zeros()

    def mode(self) -> torch.Tensor:
        return self.loc

    def mean(self) -> torch.Tensor:
        return self.loc


Bound = Union[float, torch.Tensor]


def _bound(value: Any, like: torch.Tensor) -> Bound:
    """An action bound: a number stays a Python float (no tensor to copy to
    the device at every distribution); a per-dimension one is a float32
    tensor on `like`'s device."""
    if isinstance(value, (int, float)):
        return float(value)
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def _log(x: Bound) -> Bound:
    return math.log(x) if isinstance(x, float) else torch.log(x)


class TanhNormal(Distribution):
    """tanh-squashed Normal, affinely rescaled to [minimum, maximum], as the
    JAX package's: `log_prob` clips the inverse at `threshold` below the
    bound (so an action sampled past it gets the clipped point's density),
    and `entropy` is the base entropy plus the log-det-Jacobian at the
    base's loc."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, minimum: Any = -1.0,
                 maximum: Any = 1.0, threshold: float = 0.999):
        self.base = Normal(loc, scale)
        lo, hi = _bound(minimum, loc), _bound(maximum, loc)
        self._scale = (hi - lo) / 2.0
        self._shift = (hi + lo) / 2.0
        self._threshold = threshold

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x) * self._scale + self._shift

    def _inverse(self, y: torch.Tensor) -> torch.Tensor:
        u = (y - self._shift) / self._scale
        return torch.atanh(torch.clamp(u, -self._threshold, self._threshold))

    def _log_det_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        return _log(self._scale) + 2.0 * (math.log(2.0) - x - softplus(-2.0 * x))

    def sample(self, generator: Optional[torch.Generator] = None, *,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._forward(self.base.sample(generator, noise=noise))

    def sample_and_log_prob(
        self, generator: Optional[torch.Generator] = None, *, noise: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.base.sample(generator, noise=noise)
        return self._forward(x), self.base.log_prob(x) - self._log_det_jacobian(x)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        x = self._inverse(value)
        return self.base.log_prob(x) - self._log_det_jacobian(x)

    def entropy(self) -> torch.Tensor:
        return self.base.entropy() + self._log_det_jacobian(self.base.loc)

    def mode(self) -> torch.Tensor:
        return self._forward(self.base.loc)

    def mean(self) -> torch.Tensor:
        return self._forward(self.base.loc)


def _log_beta_fn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class Beta(Distribution):
    """Beta(alpha, beta) on [0, 1]; a draw is ga / (ga + gb) from two
    standard gammas, clipped `_eps` away from 0 and 1."""

    _eps = 1e-6

    def __init__(self, alpha: torch.Tensor, beta: torch.Tensor):
        self.alpha = alpha
        self.beta = beta

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ga = torch._standard_gamma(self.alpha, generator=generator)
        gb = torch._standard_gamma(self.beta, generator=generator)
        return torch.clamp(ga / (ga + gb), self._eps, 1.0 - self._eps)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        a, b = self.alpha, self.beta
        return (a - 1) * torch.log(value) + (b - 1) * torch.log1p(-value) - _log_beta_fn(a, b)

    def entropy(self) -> torch.Tensor:
        a, b = self.alpha, self.beta
        dg = torch.digamma
        return (_log_beta_fn(a, b) - (a - 1) * dg(a) - (b - 1) * dg(b)
                + (a + b - 2) * dg(a + b))

    def mode(self) -> torch.Tensor:
        a, b = self.alpha, self.beta
        interior = (a - 1) / torch.clamp(a + b - 2, min=self._eps)
        edge = torch.where(a >= b, 1.0, 0.0)
        return torch.clamp(torch.where((a > 1) & (b > 1), interior, edge),
                           self._eps, 1 - self._eps)

    def mean(self) -> torch.Tensor:
        return self.alpha / (self.alpha + self.beta)


class AffineBeta(Independent):
    """Beta rescaled to the action interval [minimum, maximum]. As the JAX
    class, `sample_and_log_prob` is Independent's: the Beta's own draw on
    [0, 1] and its log-prob, not rescaled (ROADMAP C13)."""

    def __init__(self, alpha: torch.Tensor, beta: torch.Tensor, minimum: Any, maximum: Any):
        self._base = Beta(alpha, beta)
        self._lo = _bound(minimum, alpha)
        self._width = _bound(maximum, alpha) - self._lo
        super().__init__(self._base, 1)

    def _fwd(self, x: torch.Tensor) -> torch.Tensor:
        return self._lo + self._width * x

    def _inv(self, y: torch.Tensor) -> torch.Tensor:
        return torch.clamp((y - self._lo) / self._width, Beta._eps, 1 - Beta._eps)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._fwd(self._base.sample(generator))

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return torch.sum(self._base.log_prob(self._inv(value)) - _log(self._width), dim=-1)

    def entropy(self) -> torch.Tensor:
        return torch.sum(self._base.entropy() + _log(self._width), dim=-1)

    def mode(self) -> torch.Tensor:
        return self._fwd(self._base.mode())

    def mean(self) -> torch.Tensor:
        return self._fwd(self._base.mean())
