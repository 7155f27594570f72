"""Metrics (counterpart of the part of stoix_tpu/observability that the
divergence guard's counter needs): the process-wide registry and its
counters."""

from stoix_tpu_torch.observability.registry import Counter, MetricsRegistry, get_registry

__all__ = ["Counter", "MetricsRegistry", "get_registry"]
