"""Fault-tolerance layer (counterpart of stoix_tpu/resilience): the typed
errors the ported modules raise and the update guard (`guards`)."""

from stoix_tpu_torch.resilience.errors import ConfigValidationError, DivergenceError

__all__ = ["ConfigValidationError", "DivergenceError"]
