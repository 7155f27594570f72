"""Evaluation of the linear recurrence behind the multistep estimators
(counterpart of stoix_tpu/ops/scan_kernels.py).

    acc_t = delta_t + weight_t * acc_{t+1},        acc_T = init.

Three interchangeable implementations, with the JAX package's vocabulary:

    scan    the sequential loop in the working dtype, rounded as XLA rounds
            the JAX package's loop — the reference semantics (the default).
    assoc   log-depth doubling over the affine maps (w, d) in plain PyTorch;
            differs from `scan` only by float reassociation.
    pallas  the hand-written Hopper kernel (kernels/linear_recurrence.py) on a
            CUDA tensor, its plain version on a CPU tensor. Float32 is
            bitwise `scan`; the accumulator is float32 for bfloat16 inputs.

The process-wide default is set once per run from `system.multistep_impl`
(`configure_from_config`); estimators also accept an explicit `impl=`.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional, Tuple

import torch

from stoix_tpu_torch.kernels import linear_recurrence

VALID_IMPLS = ("scan", "assoc", "pallas")

_DEFAULT_IMPL = "scan"


def _validate_impl(impl: str) -> str:
    if impl not in VALID_IMPLS:
        raise ValueError(f"unknown multistep impl {impl!r}; valid: {', '.join(VALID_IMPLS)}")
    return impl


def set_default_impl(impl: str) -> str:
    """Set the process-wide default implementation; returns the previous one."""
    global _DEFAULT_IMPL
    previous = _DEFAULT_IMPL
    _DEFAULT_IMPL = _validate_impl(str(impl))
    return previous


def get_default_impl() -> str:
    return _DEFAULT_IMPL


def resolve_impl(impl: Optional[str]) -> str:
    """An explicit per-call impl wins; None means the process-wide default."""
    return _DEFAULT_IMPL if impl is None else _validate_impl(str(impl))


def configure_from_config(config: Any) -> str:
    """Read `system.multistep_impl` (default `scan`) and install it as the
    process default."""
    impl = str(config.system.get("multistep_impl", "scan"))
    set_default_impl(impl)
    return impl


@contextlib.contextmanager
def use_impl(impl: str) -> Iterator[str]:
    """Scoped default override (tests and benchmarks)."""
    previous = set_default_impl(impl)
    try:
        yield impl
    finally:
        set_default_impl(previous)


def _scan_reverse(
    weight_t: torch.Tensor, delta_t: torch.Tensor, init: torch.Tensor
) -> torch.Tensor:
    """acc_t = delta_t + weight_t * acc_{t+1}, looped from T-1 down to 0 in
    the inputs' dtype, rounded as XLA rounds the JAX package's loop: float32
    as one fused multiply-add per step, other dtypes as a multiply and an add
    each rounded to the dtype."""
    out = torch.empty_like(delta_t)
    acc = init
    for t in range(delta_t.shape[0] - 1, -1, -1):
        if delta_t.dtype == torch.float32:
            acc = linear_recurrence.fma_f32(weight_t[t], acc, delta_t[t])
        else:
            acc = delta_t[t] + weight_t[t] * acc
        out[t] = acc
    return out


def _assoc_reverse(
    weight_t: torch.Tensor, delta_t: torch.Tensor, init: torch.Tensor
) -> torch.Tensor:
    """Suffix composition of the maps f_t(x) = d_t + w_t·x by doubling: after
    the pass with span k, (w_t, d_t) composes f_t ∘ ... ∘ f_{t+2k-1} (maps past
    the end are identity), so ceil(log2 T) passes give every suffix."""
    w, d = weight_t, delta_t
    t_len = d.shape[0]
    k = 1
    while k < t_len:
        # f_t ∘ f_{t+k} = (w_t·w_{t+k}, d_t + w_t·d_{t+k}); the tail keeps its map.
        head_w, head_d = w[: t_len - k], d[: t_len - k]
        w = torch.cat([head_w * w[k:], w[t_len - k:]])
        d = torch.cat([head_d + head_w * d[k:], d[t_len - k:]])
        k *= 2
    return d + w * init


def linear_recurrence_reverse(
    weight_t: torch.Tensor, delta_t: torch.Tensor, init: torch.Tensor,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Suffix evaluation of acc_t = delta_t + weight_t * acc_{t+1} (acc_T =
    init) under the selected implementation. `impl=None` uses the process
    default (`system.multistep_impl`)."""
    impl = resolve_impl(impl)
    if impl == "assoc":
        return _assoc_reverse(weight_t, delta_t, init)
    if impl == "pallas":
        return linear_recurrence.linear_recurrence_reverse(
            weight_t.contiguous(), delta_t.contiguous(), init
        )
    return _scan_reverse(weight_t, delta_t, init)


# ---------------------------------------------------------------------------
# windowed n-step folds: binary doubling over the window length
# ---------------------------------------------------------------------------


def _shift_maps(w: torch.Tensor, d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maps advanced k steps toward the future, identity-padded at the tail."""
    if k == 0:
        return w, d
    ones = torch.ones((k,) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    zeros = torch.zeros((k,) + tuple(d.shape[1:]), dtype=d.dtype, device=d.device)
    return torch.cat([w[k:], ones]), torch.cat([d[k:], zeros])


def affine_window_fold(weight: torch.Tensor, delta: torch.Tensor, boot: torch.Tensor,
                       n: int) -> torch.Tensor:
    """targets[t] = (f_t ∘ f_{t+1} ∘ ... ∘ f_{t+n-1})(boot[t]) with
    f_j(x) = delta[j] + weight[j]·x, maps past the end identity, in
    O(log n) passes of binary doubling. `weight`/`delta` are time-major of
    length L ≥ len(boot); the output has `boot`'s length. Plain tensor ops:
    this windowed fold has no kernel in the JAX package either. It equals
    the n unrolled passes of `scan` up to float reassociation."""
    out_len = boot.shape[0]
    # R: the window's composed prefix (span r_span); P: the stride-doubling maps.
    r_w, r_d, r_span = torch.ones_like(weight), torch.zeros_like(delta), 0
    p_w, p_d, p_span = weight, delta, 1
    remaining = int(n)
    while remaining:
        if remaining & 1:
            # Append P after R's span: R'[t] = R[t] ∘ P[t + r_span].
            s_w, s_d = _shift_maps(p_w, p_d, r_span)
            r_w, r_d = r_w * s_w, r_d + r_w * s_d
            r_span += p_span
        remaining >>= 1
        if remaining:
            s_w, s_d = _shift_maps(p_w, p_d, p_span)
            p_w, p_d = p_w * s_w, p_d + p_w * s_d
            p_span *= 2
    return r_d[:out_len] + r_w[:out_len] * boot
