"""TelemetrySink (counterpart of stoix_tpu/observability/sink.py): fans
metrics-registry snapshots into the logger's sinks. Each logger write
refreshes `<dir>/metrics.prom` (Prometheus text, replaced atomically) and
appends a row to `<dir>/metrics.jsonl`; `close()` writes a last snapshot and
the span trace (`trace.json`), then shuts tracing down, so a run with
telemetry on leaves no enabled global state for the next run in the process.
"""

from __future__ import annotations

import time
from os.path import join
from typing import Any, Dict, Optional

from stoix_tpu_torch.observability.exporters import JsonlMetricsWriter, write_prometheus
from stoix_tpu_torch.observability.registry import MetricsRegistry, get_registry
from stoix_tpu_torch.observability.trace_export import write_chrome_trace


class TelemetrySink:
    def __init__(
        self,
        out_dir: str,
        registry: Optional[MetricsRegistry] = None,
        export_trace: bool = True,
        min_write_interval_s: float = 0.0,
    ):
        self.out_dir = out_dir
        self.prometheus_path = join(out_dir, "metrics.prom")
        self.trace_path = join(out_dir, "trace.json")
        self._registry = registry or get_registry()
        self._jsonl = JsonlMetricsWriter(join(out_dir, "metrics.jsonl"))
        self._export_trace = export_trace
        self._min_interval = float(min_write_interval_s)
        self._last_write = 0.0
        self._last_t = 0

    def write(self, metrics: Dict[str, float], t: int, t_eval: int, event: Any) -> None:
        self._last_t = int(t)
        now = time.monotonic()
        if self._min_interval and now - self._last_write < self._min_interval:
            return
        self._last_write = now
        write_prometheus(self.prometheus_path, self._registry)
        self._jsonl.write_snapshot(t, self._registry)

    def close(self) -> None:
        write_prometheus(self.prometheus_path, self._registry)
        self._jsonl.write_snapshot(self._last_t, self._registry)
        self._jsonl.close()
        if self._export_trace:
            write_chrome_trace(self.trace_path)
        from stoix_tpu_torch import observability

        observability.shutdown()
