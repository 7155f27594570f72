"""PPO losses (counterpart of stoix_tpu/ops/losses.py: `_safe_ratio`,
`ppo_clip_loss` and `clipped_value_loss`)."""

from __future__ import annotations

import torch

# Guard for exp(log_ratio): the clip region only involves |log_ratio| near
# log(1 +/- eps), so clamping at +/-20 changes nothing there but keeps the loss
# and its gradients finite when a sharpened policy meets a stale sample.
_LOG_RATIO_CLAMP = 20.0


def _safe_ratio(log_prob: torch.Tensor, old_log_prob: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(log_prob - old_log_prob, -_LOG_RATIO_CLAMP, _LOG_RATIO_CLAMP))


def ppo_clip_loss(
    log_prob: torch.Tensor, old_log_prob: torch.Tensor, advantage: torch.Tensor, epsilon: float
) -> torch.Tensor:
    """PPO clipped surrogate objective (Schulman et al. 2017)."""
    ratio = _safe_ratio(log_prob, old_log_prob)
    unclipped = ratio * advantage
    clipped = torch.clamp(ratio, 1.0 - epsilon, 1.0 + epsilon) * advantage
    return -torch.mean(torch.minimum(unclipped, clipped))


def clipped_value_loss(
    pred_value: torch.Tensor, old_value: torch.Tensor, targets: torch.Tensor, epsilon: float
) -> torch.Tensor:
    """PPO-style value clipping: max of clipped and unclipped squared errors."""
    value_clipped = old_value + torch.clamp(pred_value - old_value, -epsilon, epsilon)
    return torch.mean(
        torch.maximum(torch.square(pred_value - targets), torch.square(value_clipped - targets))
    )
