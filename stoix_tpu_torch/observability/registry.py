"""Process-wide metrics registry (counterpart of
stoix_tpu/observability/registry.py): counters, gauges, histograms with
labels, snapshots for the exporters, and `RunStats`.

Host-side and thread-safe; recording never touches a device. Names follow
the JAX package's `stoix_tpu_<area>_<name>` convention, so a metric means the
same in both packages; labels are plain string dicts, each distinct label set
its own series. `RunStats` is the dict a run's entry point refreshes once at
its end (Sebulba's `LAST_RUN_STATS`).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# Bucket upper bounds (seconds), the JAX package's: sub-millisecond
# dispatch costs up to minutes-long stalls. +Inf is implicit.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 180.0,
)


def _label_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    """One named metric family; per-label-set series live in `_series`."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, Any] = {}

    def labels_and_values(self) -> List[Tuple[LabelKey, Any]]:
        with self._lock:
            return list(self._series.items())


class Counter(_Instrument):
    """A monotonically increasing float per label set."""

    kind = "counter"

    def inc(self, amount: float = 1.0, labels: Optional[Dict[str, str]] = None) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease (got {amount})")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def total(self) -> float:
        """The sum over every label set."""
        with self._lock:
            return float(sum(self._series.values()))


class Gauge(_Instrument):
    """Last-write-wins float per label set."""

    kind = "gauge"

    def set(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class _HistogramSeries:
    __slots__ = ("count", "total", "minimum", "maximum", "bucket_counts")

    def __init__(self, n_buckets: int):
        self.count = 0
        self.total = 0.0
        self.minimum = float("inf")
        self.maximum = float("-inf")
        self.bucket_counts = [0] * (n_buckets + 1)  # last slot = +Inf


class Histogram(_Instrument):
    """Prometheus-style cumulative-bucket histogram per label set."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_text: str = "",
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help_text)
        self.buckets: Tuple[float, ...] = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name} needs at least one bucket bound")

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistogramSeries(len(self.buckets))
            series.count += 1
            series.total += value
            series.minimum = min(series.minimum, value)
            series.maximum = max(series.maximum, value)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    series.bucket_counts[i] += 1
                    break
            else:
                series.bucket_counts[-1] += 1

    def summary(self, labels: Optional[Dict[str, str]] = None) -> Dict[str, float]:
        with self._lock:
            series = self._series.get(_label_key(labels))
            if series is None or series.count == 0:
                return {"count": 0, "sum": 0.0}
            return self._summarize(series)

    @staticmethod
    def _summarize(series: _HistogramSeries) -> Dict[str, float]:
        return {
            "count": series.count,
            "sum": series.total,
            "min": series.minimum,
            "max": series.maximum,
            "mean": series.total / series.count,
        }

    def export(self) -> List[Tuple[LabelKey, Dict[str, float], Dict[float, int]]]:
        """Atomic (summary, cumulative-buckets) pairs per label set — ONE
        critical section, so an exported snapshot keeps the Prometheus
        invariant count == +Inf bucket even while other threads observe."""
        out = []
        with self._lock:
            for key, series in self._series.items():
                cumulative, buckets = 0, {}
                for bound, n in zip(self.buckets, series.bucket_counts):
                    cumulative += n
                    buckets[bound] = cumulative
                buckets[float("inf")] = cumulative + series.bucket_counts[-1]
                out.append((key, self._summarize(series), buckets))
        return out


class MetricsRegistry:
    """Named instruments; get-or-create semantics so call sites never race on
    registration. One process-wide default lives behind `get_registry()`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name: str, help_text: str, **kwargs) -> Any:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help_text, **kwargs)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name} already registered as {inst.kind}, "
                    f"requested {cls.kind}"
                )
            return inst

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help_text)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, buckets=buckets)

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            return list(self._instruments.values())

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time copy: {name: {"kind", "help", "series": [{"labels",
        "value"|"summary"}]}}. Histogram series carry count/sum/min/max/mean
        plus per-bucket cumulative counts keyed by upper bound."""
        out: Dict[str, Any] = {}
        for inst in self.instruments():
            series_list: List[Dict[str, Any]] = []
            if isinstance(inst, Histogram):
                for key, summary, buckets in inst.export():
                    series_list.append(
                        {"labels": dict(key), "summary": summary, "buckets": buckets}
                    )
            else:
                for key, raw in inst.labels_and_values():
                    series_list.append({"labels": dict(key), "value": float(raw)})
            out[inst.name] = {
                "kind": inst.kind,
                "help": inst.help,
                "series": series_list,
            }
        return out



_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


class RunStats(dict):
    """A run's stats as a plain dict: the producer publishes to the registry
    while it runs and refreshes this view once at its end; readers (tests,
    `chip_smoke.py`) use dict reads."""
