"""Invertible value transforms for scale-robust value learning (counterpart
of stoix_tpu/ops/value_transforms.py): the signed hyperbolic pair R2D2 trains
through, the identity pair, transformed n-step Q-learning TD errors, and the
scalar <-> categorical two-hot codec of the distributional MuZero heads."""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from stoix_tpu_torch.kernels.linear_recurrence import fma_f32


class TxPair(NamedTuple):
    apply: Callable[[torch.Tensor], torch.Tensor]
    apply_inv: Callable[[torch.Tensor], torch.Tensor]


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (through float64, which
    rounds it exactly once): XLA's is, and torch's vectorised CPU sqrt is
    within half an ulp but not always the nearest value, which the
    transforms' cancellation magnifies 500-fold."""
    return torch.sqrt(x.double()).float() if x.dtype == torch.float32 else torch.sqrt(x)


def _f32_like(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, float(np.float32(value)))


def signed_hyperbolic(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """h(x) = sign(x) * (sqrt(|x| + 1) - 1) + eps * x (Pohlen et al. 2018); in
    float32 the last product and sum one fused multiply-add, as XLA
    contracts them inside `jit`."""
    base = torch.sign(x) * (sqrt_f32(torch.abs(x) + 1.0) - 1.0)
    if x.dtype != torch.float32:
        return base + eps * x
    return fma_f32(x, _f32_like(eps, x), base)


def signed_parabolic(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """The inverse of `signed_hyperbolic`:
    z = sqrt(1 + 4 eps (eps + 1 + |x|)) / (2 eps) - 1 / (2 eps),
    sign(x) (z^2 - 1). In float32 as `jax.jit` evaluates it: the division by
    the constant 2 eps a product with its float32 reciprocal, and the three
    multiply-adds fused (the cancellation in z makes every rounding count)."""
    if x.dtype != torch.float32:
        z = torch.sqrt(1.0 + 4.0 * eps * (eps + 1.0 + torch.abs(x))) / (2.0 * eps) \
            - 1.0 / (2.0 * eps)
        return torch.sign(x) * (torch.square(z) - 1.0)
    reciprocal = float(np.float32(1.0) / np.float32(2.0 * eps))
    inner = fma_f32(torch.abs(x) + float(np.float32(eps + 1.0)), _f32_like(4.0 * eps, x),
                    torch.ones_like(x))
    z = fma_f32(sqrt_f32(inner), _f32_like(reciprocal, x), _f32_like(-1.0 / (2.0 * eps), x))
    return torch.sign(x) * fma_f32(z, z, -torch.ones_like(x))


IDENTITY_PAIR = TxPair(lambda x: x, lambda x: x)
SIGNED_HYPERBOLIC_PAIR = TxPair(signed_hyperbolic, signed_parabolic)


def transformed_n_step_q_learning_td(
    q_tm1: torch.Tensor,
    a_tm1: torch.Tensor,
    target_q_t: torch.Tensor,
    a_t: torch.Tensor,
    r_t: torch.Tensor,
    discount_t: torch.Tensor,
    n: int,
    tx_pair: TxPair = SIGNED_HYPERBOLIC_PAIR,
) -> torch.Tensor:
    """TD errors [T] of transformed n-step Q-learning over one sequence: the
    targets built in raw space from the untransformed bootstrap values, then
    transformed for comparison with q_tm1 (rlax's
    transformed_n_step_q_learning).

    q_tm1, target_q_t: [T+1, A]; a_tm1, a_t (the bootstrap selector): [T+1];
    r_t, discount_t: [T]."""
    from stoix_tpu_torch.ops.multistep import n_step_bootstrapped_returns

    v_t = tx_pair.apply_inv(torch.take_along_dim(target_q_t, a_t[:, None].long(), dim=-1)[:, 0])
    targets = n_step_bootstrapped_returns(r_t[None], discount_t[None], v_t[1:][None], n=n,
                                          batch_major=True)[0]
    targets = tx_pair.apply(targets)
    qa_tm1 = torch.take_along_dim(q_tm1, a_tm1[:, None].long(), dim=-1)[:, 0]
    return targets.detach() - qa_tm1[:-1]


class CategoricalTxPair(NamedTuple):
    """Scalar <-> categorical transform pair for distributional MuZero heads:
    `apply` maps raw scalars to two-hot probabilities over an atom support
    laid out in TRANSFORMED space; `apply_inv` maps logits back to raw
    scalars through the support's expectation."""

    apply: Callable[[torch.Tensor], torch.Tensor]
    apply_inv: Callable[[torch.Tensor], torch.Tensor]
    num_atoms: int


def twohot(x: torch.Tensor, atoms: torch.Tensor) -> torch.Tensor:
    """Scalars [...] as probabilities [..., N] over a uniform atom support:
    each scalar's weight split between its two neighbouring atoms."""
    num_atoms = atoms.shape[0]
    vmin, vmax = atoms[0], atoms[-1]
    step = (vmax - vmin) / (num_atoms - 1)
    x = torch.clamp(x, vmin, vmax)
    pos = (x - vmin) / step
    low = torch.clamp(torch.floor(pos), 0, num_atoms - 1)
    up_w = pos - low
    low = low.long()
    high = torch.clamp(low + 1, 0, num_atoms - 1)
    one_hot_low = F.one_hot(low, num_atoms).to(x.dtype)
    one_hot_high = F.one_hot(high, num_atoms).to(x.dtype)
    return one_hot_low * (1.0 - up_w[..., None]) + one_hot_high * up_w[..., None]


def muzero_pair(num_atoms: int = 601, vmin: float = -300.0, vmax: float = 300.0,
                tx_pair: TxPair = SIGNED_HYPERBOLIC_PAIR) -> CategoricalTxPair:
    """Categorical value and reward codec: scalar -> tx -> two-hot over the
    support (the training target); logits -> softmax expectation -> tx^-1
    (the scalar read)."""
    atoms = torch.linspace(vmin, vmax, num_atoms)

    def apply(scalar: torch.Tensor) -> torch.Tensor:
        return twohot(tx_pair.apply(scalar), atoms.to(scalar.device))

    def apply_inv(logits: torch.Tensor) -> torch.Tensor:
        probs = torch.softmax(logits, dim=-1)
        return tx_pair.apply_inv(torch.sum(probs * atoms.to(logits.device), dim=-1))

    return CategoricalTxPair(apply=apply, apply_inv=apply_inv, num_atoms=num_atoms)
