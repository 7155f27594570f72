"""RL ops (counterpart of stoix_tpu/ops): distributions, losses, estimators."""

from stoix_tpu_torch.ops.multistep import truncated_generalized_advantage_estimation

__all__ = ["truncated_generalized_advantage_estimation"]
