"""Process-wide metrics registry (counterpart of
stoix_tpu/observability/registry.py, its counters only).

Host-side and thread-safe; recording never touches a device. Names follow
the JAX package's `stoix_tpu_<area>_<name>` convention, so a counter means the
same in both packages; labels are plain string dicts, each distinct label set
its own series.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """A monotonically increasing float per label set."""

    kind = "counter"

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, labels: Optional[Dict[str, str]] = None) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease (got {amount})")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class MetricsRegistry:
    """Named counters with get-or-create semantics, so call sites never race
    on registration."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}

    def counter(self, name: str, help_text: str = "") -> Counter:
        with self._lock:
            counter = self._counters.get(name)
            if counter is None:
                counter = self._counters[name] = Counter(name, help_text)
            return counter


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY
