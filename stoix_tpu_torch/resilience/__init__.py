"""Fault-tolerance layer (counterpart of stoix_tpu/resilience); only the typed
errors the ported modules raise so far."""

from stoix_tpu_torch.resilience.errors import ConfigValidationError

__all__ = ["ConfigValidationError"]
