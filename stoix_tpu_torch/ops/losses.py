"""RL losses (counterpart of stoix_tpu/ops/losses.py): the PPO losses
(`_safe_ratio`, `ppo_clip_loss`, `ppo_penalty_loss`, `dpo_loss`,
`clipped_value_loss`) and the value-based
family's (`huber_loss`, `q_learning`, `double_q_learning`,
`munchausen_q_learning`, `categorical_l2_project`,
`categorical_double_q_learning`, `quantile_regression_loss`,
`quantile_q_learning`). Batched over a leading [B] axis; each returns a
scalar mean. `jax.lax.stop_gradient` is `detach`.
"""

from __future__ import annotations

from typing import Union

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


def ppo_penalty_loss(
    log_prob: torch.Tensor, old_log_prob: torch.Tensor, advantage: torch.Tensor,
    beta: Union[float, torch.Tensor], kl_approx: torch.Tensor,
) -> torch.Tensor:
    """PPO with a KL penalty instead of clipping."""
    ratio = _safe_ratio(log_prob, old_log_prob)
    return -torch.mean(ratio * advantage - beta * kl_approx)


def dpo_loss(
    log_prob: torch.Tensor, old_log_prob: torch.Tensor, advantage: torch.Tensor,
    alpha: float, beta: float,
) -> torch.Tensor:
    """Drift-based PPO alternative (DPO, Garcin et al.): asymmetric drift
    penalties replace the hard clip."""
    log_ratio = torch.clamp(log_prob - old_log_prob, -_LOG_RATIO_CLAMP, _LOG_RATIO_CLAMP)
    ratio = torch.exp(log_ratio)
    drift_pos = torch.relu(
        (ratio - 1.0) * advantage - alpha * torch.tanh((ratio - 1.0) * advantage / alpha))
    drift_neg = torch.relu(
        log_ratio * advantage - beta * torch.tanh(log_ratio * advantage / beta))
    drift = torch.where(advantage >= 0.0, drift_pos, drift_neg)
    return -torch.mean(ratio * advantage - drift)


def clipped_value_loss(
    pred_value: torch.Tensor, old_value: torch.Tensor, targets: torch.Tensor, epsilon: float
) -> torch.Tensor:
    """PPO-style value clipping: max of clipped and unclipped squared errors."""
    value_clipped = old_value + torch.clamp(pred_value - old_value, -epsilon, epsilon)
    return torch.mean(
        torch.maximum(torch.square(pred_value - targets), torch.square(value_clipped - targets))
    )


def huber_loss(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    abs_x = torch.abs(x)
    quadratic = torch.clamp(abs_x, max=delta)
    return 0.5 * quadratic**2 + delta * (abs_x - quadratic)


def _take(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values[..., index] along the last axis (take_along_axis then squeeze)."""
    return torch.gather(values, -1, index.long().unsqueeze(-1)).squeeze(-1)


def _td_loss(td: torch.Tensor, use_huber: bool, huber_delta: float) -> torch.Tensor:
    return torch.mean(huber_loss(td, huber_delta) if use_huber else 0.5 * td**2)


def q_learning(
    q_tm1: torch.Tensor, a_tm1: torch.Tensor, r_t: torch.Tensor, d_t: torch.Tensor,
    q_t: torch.Tensor, use_huber: bool = False, huber_delta: float = 1.0,
) -> torch.Tensor:
    """One-step Q-learning: target r + d max_a Q(s', a)."""
    target = r_t + d_t * torch.amax(q_t, dim=-1)
    td = target.detach() - _take(q_tm1, a_tm1)
    return _td_loss(td, use_huber, huber_delta)


def double_q_learning(
    q_tm1: torch.Tensor, a_tm1: torch.Tensor, r_t: torch.Tensor, d_t: torch.Tensor,
    q_t_value: torch.Tensor, q_t_selector: torch.Tensor, use_huber: bool = False,
    huber_delta: float = 1.0,
) -> torch.Tensor:
    """Double Q-learning: the selector network picks, the value network evaluates."""
    best_a = torch.argmax(q_t_selector, dim=-1)
    target = r_t + d_t * _take(q_t_value, best_a)
    td = target.detach() - _take(q_tm1, a_tm1)
    return _td_loss(td, use_huber, huber_delta)


def munchausen_q_learning(
    q_tm1: torch.Tensor, a_tm1: torch.Tensor, r_t: torch.Tensor, d_t: torch.Tensor,
    q_t_target: torch.Tensor, q_tm1_target: torch.Tensor, entropy_temperature: float,
    munchausen_coefficient: float, clip_value_min: float = -1e3,
) -> torch.Tensor:
    """Munchausen-DQN (Vieillard et al. 2020): a scaled log-policy bonus on the
    reward and a soft backup, in the JAX package's explicit expectation form."""
    tau = entropy_temperature
    logits_t = q_t_target / tau
    pi_t = torch.softmax(logits_t, dim=-1)
    soft_v_t = torch.sum(pi_t * (q_t_target - tau * torch.log(pi_t + 1e-8)), dim=-1)
    log_pi_tm1 = torch.log_softmax(q_tm1_target / tau, dim=-1)
    red_term = _take(log_pi_tm1, a_tm1)
    munchausen = munchausen_coefficient * tau * torch.clamp(red_term, clip_value_min, 0.0)
    target = r_t + munchausen + d_t * soft_v_t
    td = target.detach() - _take(q_tm1, a_tm1)
    return torch.mean(0.5 * td**2)


def categorical_l2_project(z_p: torch.Tensor, probs: torch.Tensor,
                           z_q: torch.Tensor) -> torch.Tensor:
    """Project the distribution (z_p [B, M], probs [B, M]) onto the support
    z_q [N] (Bellemare et al. 2017): each source atom's mass split between its
    two neighbouring target atoms. Returns [B, N]. The JAX package adds row by
    row under vmap (every lower share, then every upper share); here two
    batched `scatter_add`s in the same order, which may sum a target atom's
    shares in another order (within float32 reassociation).

    In float32 the grid step (vmax - vmin) / (n - 1) can round down, so the
    top atom's fractional index lands just past n - 1 (at 16 atoms on
    [0, 500]; at 51 on [0, 10] where the step is a product with the rounded
    reciprocal, as CUDA divides by a host number): its upper neighbour is
    then atom n, outside the support. JAX's `.at[].add` drops a share at an
    index outside the array; here every such share is dropped too (its
    weight zeroed, its index clamped), on every device. The step is a true
    division of two device tensors, so the card and the CPU round it alike."""
    vmin, vmax = z_q[0], z_q[-1]
    n = z_q.shape[0]
    delta_z = (vmax - vmin) / z_q.new_full((), float(n - 1))
    clipped = torch.clamp(z_p, vmin, vmax)
    bj = (clipped - vmin) / delta_z
    lower, upper = torch.floor(bj), torch.ceil(bj)
    eq = (upper == lower).to(probs.dtype)
    lower_w = (upper - bj) + eq
    upper_w = bj - lower
    out = torch.zeros(probs.shape[:-1] + (n,), dtype=probs.dtype, device=probs.device)
    for index, weight in ((lower, lower_w), (upper, upper_w)):
        inside = (index >= 0) & (index <= n - 1)
        out = out.scatter_add(-1, index.long().clamp(0, n - 1),
                              probs * torch.where(inside, weight, 0.0))
    return out


def categorical_double_q_learning(
    q_logits_tm1: torch.Tensor, q_atoms_tm1: torch.Tensor, a_tm1: torch.Tensor,
    r_t: torch.Tensor, d_t: torch.Tensor, q_logits_t: torch.Tensor, q_atoms_t: torch.Tensor,
    q_t_selector: torch.Tensor,
) -> torch.Tensor:
    """C51 double-Q loss: r + d z projected onto the fixed support, cross-entropy
    against the online logits of the taken action."""
    best_a = torch.argmax(q_t_selector, dim=-1)
    num_atoms = q_atoms_tm1.shape[-1]
    z_q = q_atoms_tm1 if q_atoms_tm1.dim() == 1 else q_atoms_tm1[0]
    target_z = torch.broadcast_to(r_t[..., None] + d_t[..., None] * q_atoms_t,
                                  r_t.shape + (num_atoms,))
    probs_t = torch.softmax(q_logits_t, dim=-1)  # [B, A, M]
    pick = lambda x, a: torch.gather(  # noqa: E731
        x, -2, a.long()[..., None, None].expand(a.shape + (1, num_atoms))).squeeze(-2)
    target = categorical_l2_project(target_z, pick(probs_t, best_a), z_q)
    logits_a = pick(q_logits_tm1, a_tm1)
    ce = -torch.sum(target.detach() * torch.log_softmax(logits_a, dim=-1), dim=-1)
    return torch.mean(ce)


def quantile_regression_loss(dist_src: torch.Tensor, tau_src: torch.Tensor,
                             dist_target: torch.Tensor, huber_param: float = 1.0
                             ) -> torch.Tensor:
    """Quantile-regression (Huber) loss, batched: dist_src [B, N], tau_src
    [B, N], dist_target [B, M]; the per-row losses (JAX's vmapped ones)
    averaged."""
    delta = dist_target.detach()[..., None, :] - dist_src[..., :, None]  # [B, N, M]
    weight = torch.abs(tau_src[..., :, None] - (delta < 0.0).to(dist_src.dtype))
    if huber_param > 0:
        loss = huber_loss(delta, huber_param) * weight
    else:
        loss = torch.abs(delta) * weight
    return torch.mean(torch.sum(torch.mean(loss, dim=-1), dim=-1))


def quantile_q_learning(
    dist_q_tm1: torch.Tensor, tau_q_tm1: torch.Tensor, a_tm1: torch.Tensor, r_t: torch.Tensor,
    d_t: torch.Tensor, dist_q_t_selector: torch.Tensor, dist_q_t: torch.Tensor,
    huber_param: float = 1.0,
) -> torch.Tensor:
    """QR-DQN loss (Dabney et al. 2018): dist_q_* [B, N, A], tau [B, N]."""
    best_a = torch.argmax(torch.mean(dist_q_t_selector, dim=1), dim=-1)
    n = dist_q_tm1.shape[1]
    pick = lambda x, a: torch.gather(  # noqa: E731
        x, -1, a.long()[:, None, None].expand(a.shape[0], n, 1)).squeeze(-1)
    target = r_t[:, None] + d_t[:, None] * pick(dist_q_t, best_a)
    return quantile_regression_loss(pick(dist_q_tm1, a_tm1), tau_q_tm1, target, huber_param)
