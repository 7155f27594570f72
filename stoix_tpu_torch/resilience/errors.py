"""Typed failures (counterpart of stoix_tpu/resilience/errors.py).

`ConfigValidationError` (`parallel/distributed.py` raises it for a
half-configured multi-process launch), `DivergenceError` (the update
guard's `halt`, resilience/guards.py), and Sebulba's `ComponentFailure` and
`EvaluatorStallError` (sebulba/core.py, resilience/supervisor.py), and
`InjectedFault` (resilience/faultinject.py). This
module imports nothing from the rest of the package.
"""

from __future__ import annotations

from typing import Optional


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


class ComponentFailure(RuntimeError):
    """Poison-pill for Sebulba: a component (actor thread, evaluator) failed
    unrecoverably. Propagated through the OnPolicyPipeline and
    ParameterServer queues so the peer FAILS FAST on its next get instead of
    burning a full collect timeout against a dead producer."""

    def __init__(self, component: str, reason: str, cause: Optional[BaseException] = None):
        self.component = component
        self.reason = reason
        self.__cause__ = cause
        detail = f": {type(cause).__name__}: {cause}" if cause is not None else ""
        super().__init__(f"{component} failed unrecoverably ({reason}){detail}")


class EvaluatorStallError(RuntimeError):
    """AsyncEvaluator.wait_until_idle timed out: evaluation work is still in
    flight (or wedged) at shutdown. Carries the evaluator's last-heartbeat
    age so the caller can tell slow-but-alive from dead."""

    def __init__(self, timeout: float, heartbeat_age: Optional[float], pending: int):
        self.timeout = float(timeout)
        self.heartbeat_age = heartbeat_age
        self.pending = int(pending)
        age = ("never completed an evaluation" if heartbeat_age is None
               else f"last finished one {heartbeat_age:.1f}s ago")
        super().__init__(
            f"async evaluator still busy after {timeout:.0f}s ({pending} request(s) "
            f"queued; {age}) — shutdown would drop in-flight evaluation work")


class InjectedFault(RuntimeError):
    """Raised by the fault-injection harness (resilience/faultinject.py) at an
    armed injection point. Distinct from real failures so supervision tests
    can assert the recovery path fired on THIS fault and not a genuine bug."""
