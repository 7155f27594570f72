"""Learning-rate schedule and the clip + Adam optimizer (counterpart of
stoix_tpu/utils/training.py and of the JAX systems'
`optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr, eps=eps))`).

The optimizer is functional over `{name: tensor}` parameter dicts and
reproduces optax's arithmetic step for step:

    g      <- g                              if ||g||_global <  max_norm
              (g / ||g||_global) * max_norm  otherwise
    mu     <- (1 - b1) * g + b1 * mu
    nu     <- (1 - b2) * g**2 + b2 * nu
    count  <- count + 1
    update <- -lr * (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count)) + eps)

with `eps` outside the square root, and `lr` read at the pre-increment count
when it is a schedule.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple, Union

import numpy as np
import torch

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
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = g_norm < self.max_grad_norm
        clipped = {
            k: torch.where(keep, g, (g / g_norm.to(g.dtype)) * self.max_grad_norm)
            for k, g in grads.items()
        }
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


def apply_updates(params: Params, updates: Params) -> Params:
    """optax.apply_updates: a new dict of `param + update`."""
    return {k: p + updates[k] for k, p in params.items()}
