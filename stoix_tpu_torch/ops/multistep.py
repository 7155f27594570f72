"""Multistep return estimators, time-major (counterpart of
stoix_tpu/ops/multistep.py: truncation-aware GAE, `lambda_returns`,
`discounted_returns`, `n_step_bootstrapped_returns`, the general off-policy
return and Retrace, the importance-corrected TD errors, `q_lambda` and
V-trace, with the JAX module's `batch_*` aliases).

Each estimator but the n-step window reduces to ONE reverse linear
recurrence over time (acc_t = delta_t + w_t * acc_{t+1}), evaluated by
ops/scan_kernels.py under `system.multistep_impl` (`scan`, `assoc`, or
`pallas`, the Hopper kernel's generic entry point).
Under `pallas`, float32 inputs with a scalar lambda take the kernel's GAE
entry point instead: delta, weights, the recurrence and the targets in one
launch on CUDA tensors (its plain version on CPU tensors), in the same
roundings. bfloat16 and a tensor lambda keep the composed path.

In float32 the elementwise ops around the recurrence round as `jax.jit`
rounds the JAX package's: every multiply-add that XLA contracts into one
fused multiply-add is stated with `fma_f32`, and Retrace's exp of the
log-ratios is XLA's own float32 exp (`xla_exp_f32`), which is not correctly
rounded.

Truncation contract: `truncation_t == 1` marks steps whose successor starts a
new episode WITHOUT a terminal discount (time-limit truncation). The current
delta still bootstraps through `v_t` (the value of the TRUE next observation,
extras["next_obs"]), but accumulation does not flow across the boundary.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch

from stoix_tpu_torch.kernels import linear_recurrence
from stoix_tpu_torch.kernels.linear_recurrence import fma_f32
from stoix_tpu_torch.ops import scan_kernels

Numeric = Union[torch.Tensor, float]


def _time_major(batch_major: bool, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    if not batch_major:
        return tensors
    return tuple(t.transpose(0, 1) if t.dim() >= 2 else t for t in tensors)


def _stop(x: torch.Tensor, stop: bool) -> torch.Tensor:
    return x.detach() if stop else x


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`a * b + c`: in float32 one fused multiply-add, as XLA contracts it
    inside `jit`; in other dtypes a multiply and an add."""
    if c.dtype == torch.float32:
        shape = torch.broadcast_shapes(a.shape, b.shape, c.shape)
        return fma_f32(*(torch.broadcast_to(x, shape) for x in (a, b, c)))
    return a * b + c


# XLA's float32 exp on the CPU (Cephes' polynomial on x = n ln 2 + a, each
# step one fused multiply-add), which `jax.jit` and eager JAX both use: about
# one value in ten differs by an ulp from a correctly rounded exp.
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
             1.6666665459e-1, 5.0000001201e-1)
_EXP_ZERO_BELOW = -87.33654  # the smallest float32 x whose exp XLA leaves above 0
_EXP_INF_FROM = 88.72284  # the smallest float32 x whose exp XLA makes inf


FusedMultiplyAdd = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def xla_exp_f32(x: torch.Tensor, fma: FusedMultiplyAdd = fma_f32) -> torch.Tensor:
    """exp of a float32 tensor, bitwise XLA's: n = min(floor(x log2(e) + 1/2), 127),
    a = x - n (0.693359375 - 2.12194440e-4), Cephes' degree-5 polynomial
    p(a) with exp(a) = p(a) a^2 + a + 1, times 2^n; 0 below the smallest
    normal's log and inf from the largest float's. `fma(a, b, c)` rounds
    a . b + c once (`fma_f32`, exact on any device, by default)."""
    def const(value: float) -> torch.Tensor:
        return torch.full_like(x, value)

    clamped = torch.clamp(x, min=-87.8, max=88.8)
    # n stops at 127 (2^127 is float32's largest power of two): near the top
    # the polynomial then runs past ln(2) / 2, as XLA's does.
    n = torch.clamp(torch.floor(fma(clamped, const(1.44269504088896341), const(0.5))),
                    max=127.0)
    a = fma(n, const(-0.693359375), clamped)
    a = fma(n, const(2.12194440e-4), a)
    y = const(_EXP_POLY[0])
    for coefficient in _EXP_POLY[1:]:
        y = fma(y, a, const(coefficient))
    y = fma(y, a * a, a) + 1.0
    # y . 2^n is exact in float64 (2^128 alone is past float32's range).
    out = torch.ldexp(y.double(), n.double()).float()
    out = torch.where(x < _EXP_ZERO_BELOW, 0.0, out)
    return torch.where(x >= _EXP_INF_FROM, math.inf, out)


# XLA's float32 log on the CPU (Cephes' logf: x = m 2^e with m in
# [sqrt(1/2), sqrt(2)), a degree-8 polynomial in m - 1): like its exp, not
# correctly rounded (about one value in nine differs from a correctly rounded
# log by an ulp).
_LOG_POLY = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
             1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
             3.3333331174e-1)
_FLOAT32_MIN_NORMAL = 1.1754943508222875e-38


def xla_log_f32(x: torch.Tensor, fma: FusedMultiplyAdd = fma_f32) -> torch.Tensor:
    """log of a float32 tensor, bitwise XLA's: the mantissa m in [1/2, 1)
    and exponent e of max(x, smallest normal), m -> 2m - 1 and e -> e - 1
    below sqrt(1/2) else m - 1, the polynomial in three interleaved parts,
    then y = p x^3 - 2.12194440e-4 e, x - x^2 / 2 + y + 0.693359375 e, each
    multiply-add one fused multiply-add (`fma`, as in `xla_exp_f32`); -inf
    at 0, inf at inf, NaN below 0."""
    def const(value: float) -> torch.Tensor:
        return torch.full_like(x, value)

    bits = torch.clamp(x, min=_FLOAT32_MIN_NORMAL).view(torch.int32)
    e = (bits >> 23).to(torch.float32) - 126.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    below = m < 0.7071067811865476
    a = (m - 1.0) + torch.where(below, m, 0.0)
    e = e - below.to(torch.float32)
    a2 = a * a
    a3 = a2 * a
    p = (fma(a, const(_LOG_POLY[0]), const(_LOG_POLY[1])),
         fma(a, const(_LOG_POLY[3]), const(_LOG_POLY[4])),
         fma(a, const(_LOG_POLY[6]), const(_LOG_POLY[7])))
    p = (fma(p[0], a, const(_LOG_POLY[2])), fma(p[1], a, const(_LOG_POLY[5])),
         fma(p[2], a, const(_LOG_POLY[8])))
    y = fma(fma(p[0], a3, p[1]), a3, p[2])
    y = fma(y, a3, -2.12194440e-4 * e)
    out = fma(const(0.693359375), e, fma(const(-0.5), a2, a) + y)
    out = torch.where(x == 0, -math.inf, out)
    out = torch.where(x == math.inf, math.inf, out)
    return torch.where(x < 0, math.nan, out)


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


def discounted_returns(
    r_t: torch.Tensor,
    discount_t: torch.Tensor,
    v_t: Numeric,
    stop_target_gradients: bool = False,
    batch_major: bool = False,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Monte-Carlo discounted returns bootstrapped with `v_t` at the sequence
    end: `lambda_returns` at lambda = 1 on `v_t` broadcast to `r_t`'s shape."""
    bootstrapped = torch.broadcast_to(
        torch.as_tensor(v_t, dtype=r_t.dtype, device=r_t.device), r_t.shape)
    return lambda_returns(r_t, discount_t, bootstrapped, 1.0, stop_target_gradients,
                          batch_major, impl)


def general_off_policy_returns_from_q_and_v(
    q_t: torch.Tensor,
    v_t: torch.Tensor,
    r_t: torch.Tensor,
    discount_t: torch.Tensor,
    c_t: torch.Tensor,
    stop_target_gradients: bool = False,
    batch_major: bool = True,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """The general off-policy return G_t = r_t + g_t (v_t - c_t q_t + c_t G_{t+1})
    (Munos et al. 2016; c_t picks IS, Q(lambda), Tree-Backup or Retrace).
    q_t and c_t cover times [1, K-1]; v_t, r_t and discount_t cover [1, K].
    ONE recurrence over the first K-1 steps with weights g_t c_t from
    G_K = r_K + g_K v_K; batch-major [B, K] by default, as the off-policy
    systems sample sequences."""
    q_t, v_t, r_t, discount_t, c_t = _time_major(batch_major, q_t, v_t, r_t, discount_t, c_t)
    g_last = _fma(discount_t[-1], v_t[-1], r_t[-1])
    delta = _fma(discount_t[:-1], _fma(-c_t, q_t, v_t[:-1]), r_t[:-1])
    returns = scan_kernels.linear_recurrence_reverse(discount_t[:-1] * c_t, delta, g_last, impl)
    returns = torch.cat([returns, g_last[None]])
    if batch_major:
        returns = returns.transpose(0, 1)
    return _stop(returns, stop_target_gradients)


def retrace_continuous(
    q_tm1: torch.Tensor,
    q_t: torch.Tensor,
    v_t: torch.Tensor,
    r_t: torch.Tensor,
    discount_t: torch.Tensor,
    log_rhos: torch.Tensor,
    lambda_: Numeric,
    stop_target_gradients: bool = True,
    batch_major: bool = True,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """The Retrace error for continuous control, the general off-policy
    return at c_t = lambda min(1, exp(log_rhos)) minus q_tm1 (the target's
    gradient stopped by default)."""
    rho = xla_exp_f32(log_rhos) if log_rhos.dtype == torch.float32 else torch.exp(log_rhos)
    c_t = torch.clamp(rho, max=1.0) * lambda_
    target = general_off_policy_returns_from_q_and_v(
        q_t, v_t, r_t, discount_t, c_t, stop_target_gradients=False, batch_major=batch_major,
        impl=impl)
    return _stop(target, stop_target_gradients) - q_tm1


def importance_corrected_td_errors(
    r_t: torch.Tensor,
    discount_t: torch.Tensor,
    rho_tm1: torch.Tensor,
    lambda_: Numeric,
    values: torch.Tensor,
    truncation_t: Optional[torch.Tensor] = None,
    stop_target_gradients: bool = False,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Per-decision importance-sampled multistep TD errors (Sutton et al.
    2014), time-major: values over [0, T], the rest over [1, T] (trailing
    batch axes allowed, where the JAX function is vmapped); a truncation
    resets the accumulation as in GAE."""
    v_tm1, v_t = values[:-1], values[1:]
    rho_t = torch.cat([rho_tm1[1:], torch.ones_like(rho_tm1[:1])])
    lam = torch.broadcast_to(torch.as_tensor(lambda_, dtype=r_t.dtype, device=r_t.device),
                             r_t.shape)
    continue_t = (torch.ones_like(r_t) if truncation_t is None
                  else 1.0 - truncation_t.to(r_t.dtype))
    delta = _fma(discount_t, v_t, r_t) - v_tm1
    errors = scan_kernels.linear_recurrence_reverse(
        discount_t * rho_t * lam * continue_t, delta, torch.zeros_like(delta[-1]), impl)
    if stop_target_gradients:
        # (rho . errors + v_tm1) - v_tm1, its first sum one multiply-add as
        # XLA contracts it.
        return _fma(rho_tm1, errors, v_tm1).detach() - v_tm1
    return rho_tm1 * errors


def vtrace_td_error_and_advantage(
    v_tm1: torch.Tensor,
    v_t: torch.Tensor,
    r_t: torch.Tensor,
    discount_t: torch.Tensor,
    rho_tm1: torch.Tensor,
    lambda_: Numeric = 1.0,
    clip_rho_threshold: float = 1.0,
    clip_pg_rho_threshold: float = 1.0,
    stop_target_gradients: bool = True,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """V-trace (IMPALA, Espeholt et al. 2018), time-major over [0, T-1] and
    [1, T] (trailing batch axes allowed): (errors = vs - v_tm1, pg_advantage =
    min(clip_pg, rho) (r + g vs_{t+1} - v_tm1), q_estimate = r + g vs_{t+1}),
    with vs - v_tm1 ONE recurrence with weights g lambda min(1, rho) over the
    deltas min(clip_rho, rho) (r + g v_t - v_tm1)."""
    rho_clipped = torch.clamp(rho_tm1, max=clip_rho_threshold)
    lam = torch.broadcast_to(torch.as_tensor(lambda_, dtype=r_t.dtype, device=r_t.device),
                             r_t.shape)
    c_t = lam * torch.clamp(rho_tm1, max=1.0)
    delta = rho_clipped * (_fma(discount_t, v_t, r_t) - v_tm1)
    corrections = scan_kernels.linear_recurrence_reverse(
        discount_t * c_t, delta, torch.zeros_like(delta[-1]), impl)
    vs = corrections + v_tm1
    vs_t = torch.cat([vs[1:], v_t[-1:]])
    pg_rho = torch.clamp(rho_tm1, max=clip_pg_rho_threshold)
    q_estimate = _fma(discount_t, vs_t, r_t)
    pg_advantage = pg_rho * (q_estimate - v_tm1)
    if stop_target_gradients:
        return vs.detach() - v_tm1, pg_advantage.detach(), q_estimate.detach()
    return vs - v_tm1, pg_advantage, q_estimate


# The JAX module's batched names, so system files read as their counterparts.
batch_truncated_generalized_advantage_estimation = truncated_generalized_advantage_estimation
batch_lambda_returns = lambda_returns
batch_discounted_returns = discounted_returns
batch_n_step_bootstrapped_returns = n_step_bootstrapped_returns
batch_general_off_policy_returns_from_q_and_v = general_off_policy_returns_from_q_and_v
batch_retrace_continuous = retrace_continuous
batch_q_lambda = q_lambda
