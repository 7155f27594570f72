"""Multistep return estimators, time-major (counterpart of
stoix_tpu/ops/multistep.py, the truncation-aware GAE subset).

The estimator reduces to ONE reverse linear recurrence over time
(acc_t = delta_t + w_t * acc_{t+1}), evaluated by ops/scan_kernels.py under
`system.multistep_impl` (`scan`, `assoc`, or `pallas`, the Hopper kernel).

Truncation contract: `truncation_t == 1` marks steps whose successor starts a
new episode WITHOUT a terminal discount (time-limit truncation). The current
delta still bootstraps through `v_t` (the value of the TRUE next observation,
extras["next_obs"]), but accumulation does not flow across the boundary.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from stoix_tpu_torch.ops import scan_kernels

Numeric = Union[torch.Tensor, float]


def _time_major(batch_major: bool, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    if not batch_major:
        return tensors
    return tuple(t.transpose(0, 1) if t.dim() >= 2 else t for t in tensors)


def _broadcast_param(param: Numeric, like: torch.Tensor, batch_major: bool) -> torch.Tensor:
    """Broadcast a scalar-or-tensor parameter (e.g. lambda) to `like`'s
    (already time-major) shape, transposing tensor params given batch-major."""
    param = torch.as_tensor(param, dtype=like.dtype, device=like.device)
    if batch_major and param.dim() >= 2:
        param = param.transpose(0, 1)
    return torch.broadcast_to(param, like.shape)


def truncated_generalized_advantage_estimation(
    r_t: torch.Tensor,
    discount_t: torch.Tensor,
    lambda_: Numeric,
    values: Optional[torch.Tensor] = None,
    v_tm1: Optional[torch.Tensor] = None,
    v_t: Optional[torch.Tensor] = None,
    truncation_t: Optional[torch.Tensor] = None,
    stop_target_gradients: bool = False,
    batch_major: bool = False,
    standardize_advantages: bool = False,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE with truncation-aware accumulator resets.

    Either pass `values` at times [0, T] (shape [T+1, ...]) — the convenience
    path when there are no truncations — or pass `v_tm1` (values of the states
    acted from) and `v_t` (values of the TRUE successor states, including at
    auto-reset boundaries) separately, which truncation requires. Returns
    `(advantages, value_targets)` at times [0, T-1].
    """
    if values is not None:
        values_tm = _time_major(batch_major, values)[0]
        v_tm1, v_t = values_tm[:-1], values_tm[1:]
        r_t, discount_t = _time_major(batch_major, r_t, discount_t)
    else:
        if v_tm1.shape != v_t.shape:
            raise ValueError(f"v_tm1 {tuple(v_tm1.shape)} != v_t {tuple(v_t.shape)}")
        r_t, discount_t, v_tm1, v_t = _time_major(batch_major, r_t, discount_t, v_tm1, v_t)
    shapes = {tuple(x.shape) for x in (r_t, discount_t, v_tm1, v_t)}
    if len(shapes) != 1:
        raise ValueError(f"GAE inputs disagree in shape: {sorted(shapes)}")

    lam = _broadcast_param(lambda_, r_t, batch_major)
    if truncation_t is None:
        continue_t = torch.ones_like(r_t)
    else:
        truncation_t = _time_major(batch_major, truncation_t)[0]
        continue_t = 1.0 - truncation_t.to(r_t.dtype)

    delta_t = r_t + discount_t * v_t - v_tm1
    advantages = scan_kernels.linear_recurrence_reverse(
        discount_t * lam * continue_t, delta_t, torch.zeros_like(delta_t[-1]), impl
    )
    targets = v_tm1 + advantages

    if batch_major:
        advantages, targets = advantages.transpose(0, 1), targets.transpose(0, 1)
    if standardize_advantages:
        # Population std (ddof 0), as jnp.std.
        advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
    if stop_target_gradients:
        return advantages.detach(), targets.detach()
    return advantages, targets
