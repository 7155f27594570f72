"""Metrics and Sebulba health (counterpart of the part of
stoix_tpu/observability that the divergence guard and the Sebulba loop use):
the process-wide registry (counters, gauges, histograms, `RunStats`), the
heartbeat board and stall detector, and the span seams."""

from stoix_tpu_torch.observability.health import (
    ActorStarvationError,
    HeartbeatBoard,
    StallDetector,
)
from stoix_tpu_torch.observability.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RunStats,
    get_registry,
)
from stoix_tpu_torch.observability.trace import annotate, span

__all__ = [
    "ActorStarvationError", "Counter", "Gauge", "HeartbeatBoard", "Histogram",
    "MetricsRegistry", "RunStats", "StallDetector", "annotate", "get_registry", "span",
]
