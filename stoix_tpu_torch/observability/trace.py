"""Host-side span tracing (counterpart of stoix_tpu/observability/trace.py).

`span("learn_dispatch")` records one complete event (Chrome trace
`"ph": "X"`) into a process-wide buffer while tracing is enabled
(`logger.telemetry.enabled`, through `observability.configure`); disabled
(the default) it returns a shared no-op context manager: one boolean check,
no allocation, so the loops keep their spans unconditionally. Timestamps are
`time.perf_counter_ns()` against a per-recorder epoch, in microseconds, the
Chrome trace-event unit (trace_export.py writes the file).

`annotate(name)` tags a learner function for the profiler's trace as the
JAX package's `jax.named_scope` does; `device_annotation(name)` names a
dispatch site on the device timeline (`torch.profiler.record_function`),
which costs next to nothing when no profiler is running.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, Dict, List


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> None:
        return None


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_recorder", "_name", "_args", "_start")

    def __init__(self, recorder: "TraceRecorder", name: str, args: Dict[str, Any]):
        self._recorder = recorder
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._recorder._record(self._name, self._start, time.perf_counter_ns(), self._args)


class TraceRecorder:
    """Bounded in-memory buffer of complete span events.

    `max_events` caps memory for long runs (drops record a counter so the
    export can say how many were lost — silent truncation would read as
    "nothing else happened")."""

    def __init__(self, max_events: int = 200_000):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._thread_names: Dict[int, str] = {}
        self._epoch_ns = time.perf_counter_ns()
        self._max_events = max_events
        self.dropped = 0
        self.enabled = False

    def span(self, name: str, **args: Any):
        if not self.enabled:
            return _NOOP
        return _Span(self, name, args)

    def _record(self, name: str, start_ns: int, end_ns: int, args: Dict[str, Any]) -> None:
        thread = threading.current_thread()
        tid = thread.ident or 0
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = thread.name
            if len(self._events) >= self._max_events:
                self.dropped += 1
                return
            self._events.append(
                {
                    "name": name,
                    "ts": (start_ns - self._epoch_ns) / 1e3,  # microseconds
                    "dur": (end_ns - start_ns) / 1e3,
                    "tid": tid,
                    "args": {k: _jsonable(v) for k, v in args.items()},
                }
            )

    def instant(self, name: str, **args: Any) -> None:
        """Zero-duration marker (exported as a Chrome instant event)."""
        if not self.enabled:
            return
        now = time.perf_counter_ns()
        self._record(name, now, now, args)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def thread_names(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._thread_names)

    def event_count(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._thread_names.clear()
            self.dropped = 0
            self._epoch_ns = time.perf_counter_ns()


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


_RECORDER = TraceRecorder()


def get_recorder() -> TraceRecorder:
    return _RECORDER


def span(name: str, **args: Any):
    """Context manager timing one host-side phase. No-op unless tracing is
    enabled (observability.configure / set_enabled)."""
    return _RECORDER.span(name, **args)


def instant(name: str, **args: Any) -> None:
    _RECORDER.instant(name, **args)


def set_enabled(enabled: bool) -> None:
    _RECORDER.enabled = bool(enabled)


def is_enabled() -> bool:
    return _RECORDER.enabled


def annotate(name: str) -> Callable[[Callable], Callable]:
    """A taxonomy tag for a learner function: while tracing is enabled each
    call runs inside `torch.profiler.record_function(name)`; disabled, the
    function runs as it is."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def tagged(*args: Any, **kwargs: Any) -> Any:
            if not _RECORDER.enabled:
                return fn(*args, **kwargs)
            with device_annotation(name):
                return fn(*args, **kwargs)

        return tagged

    return wrap


def device_annotation(name: str):
    """Names a host dispatch site on the profiler's timeline
    (`torch.profiler.record_function`)."""
    import torch

    return torch.profiler.record_function(name)
