"""Fault-tolerance layer (counterpart of stoix_tpu/resilience): the typed
errors the ported modules raise, the update guard (`guards`) and Sebulba's
actor supervisor (`supervisor`)."""

from stoix_tpu_torch.resilience.errors import (
    ComponentFailure,
    ConfigValidationError,
    DivergenceError,
    EvaluatorStallError,
)

__all__ = ["ComponentFailure", "ConfigValidationError", "DivergenceError",
           "EvaluatorStallError"]
