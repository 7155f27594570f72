"""RL ops (counterpart of stoix_tpu/ops): distributions, losses, estimators,
value transforms, attention."""

from stoix_tpu_torch.ops.multistep import (
    batch_discounted_returns,
    batch_general_off_policy_returns_from_q_and_v,
    batch_lambda_returns,
    batch_n_step_bootstrapped_returns,
    batch_q_lambda,
    batch_retrace_continuous,
    batch_truncated_generalized_advantage_estimation,
    discounted_returns,
    general_off_policy_returns_from_q_and_v,
    importance_corrected_td_errors,
    lambda_returns,
    n_step_bootstrapped_returns,
    q_lambda,
    retrace_continuous,
    truncated_generalized_advantage_estimation,
    vtrace_td_error_and_advantage,
)
from stoix_tpu_torch.ops.pallas_attention import best_attention, flash_attention
from stoix_tpu_torch.ops.ring_attention import full_attention, make_ring_attention
from stoix_tpu_torch.ops.value_transforms import IDENTITY_PAIR, SIGNED_HYPERBOLIC_PAIR

__all__ = [
    "IDENTITY_PAIR",
    "SIGNED_HYPERBOLIC_PAIR",
    "batch_discounted_returns",
    "batch_general_off_policy_returns_from_q_and_v",
    "batch_lambda_returns",
    "batch_n_step_bootstrapped_returns",
    "batch_q_lambda",
    "batch_retrace_continuous",
    "batch_truncated_generalized_advantage_estimation",
    "best_attention",
    "discounted_returns",
    "flash_attention",
    "full_attention",
    "general_off_policy_returns_from_q_and_v",
    "importance_corrected_td_errors",
    "lambda_returns",
    "make_ring_attention",
    "n_step_bootstrapped_returns",
    "q_lambda",
    "retrace_continuous",
    "truncated_generalized_advantage_estimation",
    "vtrace_td_error_and_advantage",
]
