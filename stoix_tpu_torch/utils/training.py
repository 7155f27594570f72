"""Learning-rate schedule, the clip + Adam and clip + RAdam optimizers and
the Polyak target update (counterpart of stoix_tpu/utils/training.py and of
the JAX systems' `optax.chain(optax.clip_by_global_norm(max_norm),
optax.adam(lr, eps=eps))`, ff_pqn's `optax.chain(clip_by_global_norm,
optax.radam(lr))` and `optax.incremental_update`).

The optimizers are functional over `{name: tensor}` parameter dicts and
reproduce optax's arithmetic step for step. Clip + Adam:

    g      <- g                              if ||g||_global <  max_norm
              (g / ||g||_global) * max_norm  otherwise
    mu     <- (1 - b1) * g + b1 * mu
    nu     <- (1 - b2) * g**2 + b2 * nu
    count  <- count + 1
    update <- -lr * (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count)) + eps)

with `eps` outside the square root, and `lr` read at the pre-increment count
when it is a schedule. Clip + RAdam (optax.radam: b1 0.9, b2 0.999, eps 1e-8,
threshold 5; not torch.optim.RAdam, whose rectification differs):

    rho_inf <- 2 / (1 - b2) - 1,   rho <- rho_inf - 2 count b2**count / (1 - b2**count)
    update  <- -lr * r * mu_hat / (sqrt(nu_hat) + eps)   if rho >= 5
               -lr * mu_hat                               otherwise
    r       <- sqrt((rho - 4)(rho - 2) rho_inf / ((rho_inf - 4)(rho_inf - 2) rho))

The step count is a host int, so rho, r and the bias corrections are host
float32 numbers (as optax computes them in float32) and nothing syncs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple, Union

import numpy as np
import torch

from stoix_tpu_torch.kernels.linear_recurrence import fma_f32

LearningRate = Union[float, Callable[[int], float]]
ADAM_B1, ADAM_B2 = 0.9, 0.999  # optax.adam's defaults, which the JAX systems use
Params = Dict[str, torch.Tensor]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable:
    """optax.linear_schedule: init -> end linearly over `transition_steps`."""

    def schedule(count: int) -> float:
        done = min(max(count, 0), transition_steps)
        return (init_value - end_value) * (1.0 - done / transition_steps) + end_value

    return schedule


def make_learning_rate(
    init_lr: float, config: Any, epochs: int = 1, num_minibatches: int = 1
) -> LearningRate:
    """Constant LR, or linear decay to 0 over every optimizer step of the run
    when `system.decay_learning_rates` is set."""
    if not config.system.get("decay_learning_rates", False):
        return init_lr
    total_steps = int(config.arch.num_updates) * int(epochs) * int(num_minibatches)
    return linear_schedule(init_lr, 0.0, max(1, total_steps))


class ClipAdamState(NamedTuple):
    count: int  # optimizer steps taken (a host int: no device sync to read it)
    mu: Params
    nu: Params


class ClipAdam:
    """Global-norm clip followed by Adam, on parameter dicts."""

    def __init__(self, learning_rate: LearningRate, max_grad_norm: float, eps: float = 1e-5):
        self.learning_rate = learning_rate
        self.max_grad_norm = float(max_grad_norm)
        self.eps = float(eps)

    def init(self, params: Params) -> ClipAdamState:
        zeros = {k: torch.zeros_like(v, memory_format=torch.contiguous_format)
                 for k, v in params.items()}
        return ClipAdamState(0, zeros, {k: v.clone() for k, v in zeros.items()})

    def update(self, grads: Params, state: ClipAdamState) -> Tuple[Params, ClipAdamState]:
        """Returns (updates to add to the params, next state)."""
        clipped = clip_by_global_norm(grads, self.max_grad_norm)
        count = state.count + 1
        b1, b2 = ADAM_B1, ADAM_B2
        # Bias corrections in float32 on the host, as optax computes decay**count.
        correction1 = float(np.float32(1.0) - np.float32(b1) ** count)
        correction2 = float(np.float32(1.0) - np.float32(b2) ** count)
        lr = self.learning_rate
        lr = lr(state.count) if callable(lr) else lr
        mu, nu, updates = {}, {}, {}
        for k, g in clipped.items():
            mu[k] = (1.0 - b1) * g + b1 * state.mu[k]
            nu[k] = (1.0 - b2) * (g * g) + b2 * state.nu[k]
            mu_hat = mu[k] / correction1
            nu_hat = nu[k] / correction2
            updates[k] = (mu_hat / (torch.sqrt(nu_hat) + self.eps)) * -lr
        return updates, ClipAdamState(count, mu, nu)


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """optax.clip_by_global_norm: every gradient scaled by max_norm / ||g||
    when the global norm reaches max_norm."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = g_norm < max_norm
    return {k: torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm)
            for k, g in grads.items()}


class ClipRAdam(ClipAdam):
    """Global-norm clip followed by optax's RAdam (eps 1e-8, threshold 5)."""

    def __init__(self, learning_rate: LearningRate, max_grad_norm: float, eps: float = 1e-8,
                 threshold: float = 5.0):
        super().__init__(learning_rate, max_grad_norm, eps)
        self.threshold = float(threshold)

    def update(self, grads: Params, state: ClipAdamState) -> Tuple[Params, ClipAdamState]:
        clipped = clip_by_global_norm(grads, self.max_grad_norm)
        count = state.count + 1
        b1, b2 = ADAM_B1, ADAM_B2
        f32 = np.float32
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = f32(b2) ** f32(count)
        ro = f32(ro_inf) - f32(2) * f32(count) * b2t / (f32(1) - b2t)
        correction1 = float(f32(1.0) - f32(b1) ** count)
        correction2 = float(f32(1.0) - f32(b2) ** count)
        rectified = bool(ro >= self.threshold)
        if rectified:
            r = float(np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                              / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))
        lr = self.learning_rate
        lr = lr(state.count) if callable(lr) else lr
        mu, nu, updates = {}, {}, {}
        for k, g in clipped.items():
            mu[k] = (1.0 - b1) * g + b1 * state.mu[k]
            nu[k] = (1.0 - b2) * (g * g) + b2 * state.nu[k]
            mu_hat = mu[k] / correction1
            if rectified:
                step = r * mu_hat / (torch.sqrt(nu[k] / correction2) + self.eps)
            else:
                step = mu_hat
            updates[k] = step * -lr
        return updates, ClipAdamState(count, mu, nu)


def incremental_update(new: Params, old: Params, step_size: float) -> Params:
    """optax.incremental_update, the Polyak target update
    `step_size * new + (1 - step_size) * old`: in float32 one fused
    multiply-add, fma(step_size, new, (1 - step_size) * old), as XLA contracts
    it inside `jit`, over all float32 leaves at once (one flat vector: the
    same elementwise result in a handful of launches, not a handful a leaf)."""
    out = {}
    wide = [k for k, n in new.items() if n.dtype == torch.float32]
    for k, n in new.items():
        if n.dtype != torch.float32:
            out[k] = step_size * n + (1.0 - step_size) * old[k]
    if wide:
        flat_new = torch.cat([new[k].reshape(-1) for k in wide])
        rest = (1.0 - step_size) * torch.cat([old[k].reshape(-1) for k in wide])
        flat = fma_f32(torch.full_like(flat_new, step_size), flat_new, rest)
        for k, part in zip(wide, flat.split([new[k].numel() for k in wide])):
            out[k] = part.view(new[k].shape)
    return {k: out[k] for k in new}


def apply_updates(params: Params, updates: Params) -> Params:
    """optax.apply_updates: a new dict of `param + update`."""
    return {k: p + updates[k] for k, p in params.items()}
