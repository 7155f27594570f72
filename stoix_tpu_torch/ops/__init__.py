"""RL ops (counterpart of stoix_tpu/ops): distributions, losses, estimators,
value transforms, attention."""

from stoix_tpu_torch.ops.multistep import (
    n_step_bootstrapped_returns,
    truncated_generalized_advantage_estimation,
)
from stoix_tpu_torch.ops.pallas_attention import best_attention, flash_attention
from stoix_tpu_torch.ops.ring_attention import full_attention, make_ring_attention
from stoix_tpu_torch.ops.value_transforms import IDENTITY_PAIR, SIGNED_HYPERBOLIC_PAIR

__all__ = [
    "IDENTITY_PAIR",
    "SIGNED_HYPERBOLIC_PAIR",
    "best_attention",
    "flash_attention",
    "full_attention",
    "make_ring_attention",
    "n_step_bootstrapped_returns",
    "truncated_generalized_advantage_estimation",
]
