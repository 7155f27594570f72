"""Fault-tolerance layer (counterpart of stoix_tpu/resilience): the typed
errors the ported modules raise, the update guard (`guards`), Sebulba's
actor supervisor (`supervisor`) and its fault injection (`faultinject`)."""

from stoix_tpu_torch.resilience.errors import (
    ComponentFailure,
    ConfigValidationError,
    DivergenceError,
    EvaluatorStallError,
    InjectedFault,
)

__all__ = ["ComponentFailure", "ConfigValidationError", "DivergenceError",
           "EvaluatorStallError", "InjectedFault"]
