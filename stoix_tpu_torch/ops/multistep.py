"""Multistep return estimators, time-major (counterpart of
stoix_tpu/ops/multistep.py: truncation-aware GAE, `lambda_returns` and
`q_lambda`).

Each estimator reduces to ONE reverse linear recurrence over time
(acc_t = delta_t + w_t * acc_{t+1}), evaluated by ops/scan_kernels.py under
`system.multistep_impl` (`scan`, `assoc`, or `pallas`, the Hopper kernel).
Under `pallas`, float32 inputs with a scalar lambda take the kernel's GAE
entry point instead: delta, weights, the recurrence and the targets in one
launch on CUDA tensors (its plain version on CPU tensors), in the same
roundings. bfloat16 and a tensor lambda keep the composed path.

Truncation contract: `truncation_t == 1` marks steps whose successor starts a
new episode WITHOUT a terminal discount (time-limit truncation). The current
delta still bootstraps through `v_t` (the value of the TRUE next observation,
extras["next_obs"]), but accumulation does not flow across the boundary.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from stoix_tpu_torch.kernels import linear_recurrence
from stoix_tpu_torch.kernels.linear_recurrence import fma_f32
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


def _composed_gae(r_t, discount_t, v_tm1, v_t, truncation_t, lambda_, batch_major, impl):
    """GAE's elementwise ops around ONE recurrence, each op on its own, in the
    JAX package's order. Returns (advantages, targets), time-major."""
    lam = _broadcast_param(lambda_, r_t, batch_major)
    if truncation_t is None:
        continue_t = torch.ones_like(r_t)
    else:
        continue_t = 1.0 - truncation_t.to(r_t.dtype)

    # XLA contracts the JAX package's `r_t + discount_t * v_t` into one fused
    # multiply-add inside `jit` (where that package always runs GAE); state it.
    if r_t.dtype == torch.float32:
        delta_t = fma_f32(discount_t, v_t, r_t) - v_tm1
    else:
        delta_t = r_t + discount_t * v_t - v_tm1
    advantages = scan_kernels.linear_recurrence_reverse(
        discount_t * lam * continue_t, delta_t, torch.zeros_like(delta_t[-1]), impl
    )
    return advantages, v_tm1 + advantages


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

    if truncation_t is not None:
        truncation_t = _time_major(batch_major, truncation_t)[0]
    fused = (
        scan_kernels.resolve_impl(impl) == "pallas"
        and isinstance(lambda_, (int, float))
        and all(x.dtype == torch.float32 for x in (r_t, discount_t, v_tm1, v_t))
    )
    if fused:
        # The kernel takes contiguous float32 inputs: batch-major views are
        # copied here, once; time-major rollouts pass through untouched.
        if truncation_t is not None:
            truncation_t = truncation_t.to(torch.float32)
        advantages, targets = linear_recurrence.truncated_gae(
            *(None if x is None else x.contiguous()
              for x in (r_t, discount_t, v_tm1, v_t, truncation_t)),
            lambda_,
        )
    else:
        advantages, targets = _composed_gae(
            r_t, discount_t, v_tm1, v_t, truncation_t, lambda_, batch_major, impl)

    if batch_major:
        advantages, targets = advantages.transpose(0, 1), targets.transpose(0, 1)
    if standardize_advantages:
        # Population std (ddof 0), as jnp.std.
        advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
    if stop_target_gradients:
        return advantages.detach(), targets.detach()
    return advantages, targets


def lambda_returns(
    r_t: torch.Tensor,
    discount_t: torch.Tensor,
    v_t: torch.Tensor,
    lambda_: Numeric = 1.0,
    stop_target_gradients: bool = False,
    batch_major: bool = False,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """TD(lambda) returns: G_t = r_t + g_t [(1 - lambda_t) v_t + lambda_t G_{t+1}],
    through ONE `linear_recurrence_reverse` (B1's generic entry point under
    `pallas`) with weights g_t lambda_t, deltas r_t + g_t (1 - lambda_t) v_t and
    G_T's bootstrap v_t[-1]. In float32 the delta is one fused multiply-add,
    as XLA contracts it inside `jit`."""
    r_t, discount_t, v_t = _time_major(batch_major, r_t, discount_t, v_t)
    lam = _broadcast_param(lambda_, r_t, batch_major)
    if r_t.dtype == torch.float32:
        delta = fma_f32(discount_t * (1.0 - lam), v_t, r_t)
    else:
        delta = r_t + discount_t * (1.0 - lam) * v_t
    returns = scan_kernels.linear_recurrence_reverse(discount_t * lam, delta, v_t[-1], impl)
    if batch_major:
        returns = returns.transpose(0, 1)
    return returns.detach() if stop_target_gradients else returns


def q_lambda(
    r_t: torch.Tensor,
    discount_t: torch.Tensor,
    q_t: torch.Tensor,
    lambda_: Numeric,
    stop_target_gradients: bool = True,
    batch_major: bool = True,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Peng's Q(lambda) targets: lambda returns over max_a Q(s_t, a)."""
    return lambda_returns(r_t, discount_t, torch.amax(q_t, dim=-1), lambda_,
                          stop_target_gradients, batch_major=batch_major, impl=impl)


def n_step_bootstrapped_returns(
    r_t: torch.Tensor,
    discount_t: torch.Tensor,
    v_t: torch.Tensor,
    n: int,
    lambda_t: Numeric = 1.0,
    stop_target_gradients: bool = True,
    batch_major: bool = True,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Strided n-step bootstrapped returns, batch-major [B, T] by default (as
    the off-policy systems sample their buffers):

        G_t = r_{t+1} + g_{t+1}(r_{t+2} + g_{t+2}( ... (r_{t+n} + g_{t+n} v_{t+n}))),

    with lambda mixing in the value at each step; sequences shorter than n at
    the tail bootstrap from the final value. A WINDOW of exactly n affine maps
    per output, not a suffix recurrence, so no kernel runs here: under `scan`
    the n unrolled vector passes of the JAX package (in float32 each pass
    rounded as `jax.jit` rounds it, two fused multiply-adds); under `assoc` and
    `pallas` (which has no windowed kernel, in the JAX package either)
    `scan_kernels.affine_window_fold`'s O(log n) shifted compositions."""
    r_t, discount_t, v_t = _time_major(batch_major, r_t, discount_t, v_t)
    seq_len = r_t.shape[0]
    lam = _broadcast_param(lambda_t, r_t, batch_major)

    pad = n - 1
    # The bootstrap targets start n-1 steps ahead; the tail repeats the last value.
    tail = v_t[-1:].expand((min(pad, seq_len),) + tuple(v_t.shape[1:]))
    targets = torch.cat([v_t[pad:], tail])

    def padded(x: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, fill.expand((pad,) + tuple(x.shape[1:]))])

    zero, one = r_t.new_zeros(()), r_t.new_ones(())
    r_pad, g_pad, l_pad = padded(r_t, zero), padded(discount_t, one), padded(lam, one)
    v_pad = padded(v_t, v_t[-1:])

    if scan_kernels.resolve_impl(impl) == "scan":
        for i in reversed(range(n)):
            r, g, lam_i, v = (x[i:i + seq_len] for x in (r_pad, g_pad, l_pad, v_pad))
            if targets.dtype == torch.float32:
                # XLA contracts both the mix and the step into fused
                # multiply-adds inside `jit`: fma(1 - lambda, v, lambda.G) and
                # fma(g, mix, r). State them.
                targets = fma_f32(g, fma_f32(1.0 - lam_i, v, lam_i * targets), r)
            else:
                targets = r + g * ((1.0 - lam_i) * v + lam_i * targets)
    else:
        # Per-step affine maps f_j(x) = d_j + w_j.x; the identity padding
        # (w = 1, d = 0) past seq_len is the scan's r = 0, g = 1, lambda = 1.
        weight = g_pad * l_pad
        delta = r_pad + g_pad * (1.0 - l_pad) * v_pad
        targets = scan_kernels.affine_window_fold(weight, delta, targets, n)
    if batch_major:
        targets = targets.transpose(0, 1)
    return targets.detach() if stop_target_gradients else targets
