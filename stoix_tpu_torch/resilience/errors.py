"""Typed failures (counterpart of stoix_tpu/resilience/errors.py).

`ConfigValidationError` (`parallel/distributed.py` raises it for a
half-configured multi-process launch) and `DivergenceError` (the update
guard's `halt`, resilience/guards.py). This module imports nothing from the
rest of the package.
"""

from __future__ import annotations


class DivergenceError(RuntimeError):
    """Raised on the host by `system.update_guard=halt` once a window's metrics
    are materialised and the guard flagged a non-finite loss or global
    grad-norm. Names the step, the loss and the offending metric."""

    def __init__(self, step: int, loss: float, grad_norm: float, metric: str):
        self.step = int(step)
        self.loss = float(loss)
        self.grad_norm = float(grad_norm)
        self.metric = metric
        super().__init__(
            f"learner diverged at step {self.step}: non-finite {metric} "
            f"(loss={self.loss}, grad_norm={self.grad_norm}); the guarded "
            f"update was NOT applied (update_guard=halt). Re-run with "
            f"system.update_guard=skip to drop bad updates instead of halting."
        )


class ConfigValidationError(RuntimeError):
    """Config cross-validation (arch × system × network × env) failed before
    any device work. Carries ALL findings, not just the first, so one preflight
    run fixes the whole config."""

    def __init__(self, findings: list):
        self.findings = list(findings)
        lines = "\n".join(f"  - {f}" for f in self.findings)
        super().__init__(
            f"config validation failed with {len(self.findings)} finding(s):\n{lines}"
        )
