"""RL ops (counterpart of stoix_tpu/ops): distributions, losses, estimators, attention."""

from stoix_tpu_torch.ops.multistep import truncated_generalized_advantage_estimation
from stoix_tpu_torch.ops.pallas_attention import best_attention, flash_attention
from stoix_tpu_torch.ops.ring_attention import full_attention, make_ring_attention

__all__ = [
    "best_attention",
    "flash_attention",
    "full_attention",
    "make_ring_attention",
    "truncated_generalized_advantage_estimation",
]
