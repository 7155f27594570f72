"""RL ops (counterpart of stoix_tpu/ops): distributions, losses, estimators, attention."""

from stoix_tpu_torch.ops.multistep import truncated_generalized_advantage_estimation
from stoix_tpu_torch.ops.pallas_attention import best_attention, flash_attention

__all__ = ["best_attention", "flash_attention", "truncated_generalized_advantage_estimation"]
