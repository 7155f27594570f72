"""Process-wide metrics registry (counterpart of
stoix_tpu/observability/registry.py): counters, gauges, histograms with
labels, and `RunStats`.

Host-side and thread-safe; recording never touches a device. Names follow
the JAX package's `stoix_tpu_<area>_<name>` convention, so a metric means the
same in both packages; labels are plain string dicts, each distinct label set
its own series. `RunStats` is the dict a run's entry point refreshes once at
its end (Sebulba's `LAST_RUN_STATS`).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


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
    __slots__ = ("count", "total", "minimum", "maximum")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.minimum = float("inf")
        self.maximum = float("-inf")


class Histogram(_Instrument):
    """Observations per label set, summarised by count, sum, min, max and
    mean. (The JAX package's also keeps Prometheus buckets for its
    exporters, which are not ported.)"""

    kind = "histogram"

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistogramSeries()
            series.count += 1
            series.total += value
            series.minimum = min(series.minimum, value)
            series.maximum = max(series.maximum, value)

    def summary(self, labels: Optional[Dict[str, str]] = None) -> Dict[str, float]:
        """count, sum, min, max and mean of one label set ({count: 0, sum: 0}
        when it has no sample)."""
        with self._lock:
            series = self._series.get(_label_key(labels))
            if series is None or series.count == 0:
                return {"count": 0, "sum": 0.0}
            return {"count": series.count, "sum": series.total, "min": series.minimum,
                    "max": series.maximum, "mean": series.total / series.count}


class MetricsRegistry:
    """Named instruments with get-or-create semantics, so call sites never
    race on registration."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name: str, help_text: str) -> Any:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help_text)
            elif not isinstance(inst, cls):
                raise TypeError(f"metric {name} already registered as {inst.kind}, "
                                f"requested {cls.kind}")
            return inst

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help_text)

    def histogram(self, name: str, help_text: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, help_text)


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


class RunStats(dict):
    """A run's stats as a plain dict: the producer publishes to the registry
    while it runs and refreshes this view once at its end; readers (tests,
    `chip_smoke.py`) use dict reads."""
