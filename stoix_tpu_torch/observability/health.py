"""Health (counterpart of stoix_tpu/observability/health.py): heartbeats
per component, a stall detector that NAMES the starved side instead of
surfacing an anonymous `queue.Empty`, and the process-wide `HealthMonitor`
that `/healthz` reads (observability/httpz.py).

Every Sebulba component (actor-i, learner, param-server, evaluator) beats a
`HeartbeatBoard` each time it completes a unit of work. When the learner's
collect times out, `diagnose()` turns heartbeat ages into a verdict: an actor
that stopped beating is dead or starved; an actor that IS beating while the
learner times out means the hand-off is wedged. Ages also export as the
gauge `stoix_tpu_sebulba_heartbeat_age_seconds{component=...}`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from stoix_tpu_torch.observability.registry import MetricsRegistry, get_registry


class HeartbeatBoard:
    """Monotonic last-beat timestamps per component name; thread-safe."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self._beats: Dict[str, float] = {}
        self._registry = registry or get_registry()
        self._beat_counter = self._registry.counter(
            "stoix_tpu_sebulba_heartbeats_total", "Completed work units per Sebulba component")

    def beat(self, component: str) -> None:
        now = time.monotonic()
        with self._lock:
            self._beats[component] = now
        self._beat_counter.inc(labels={"component": component})

    def age(self, component: str) -> Optional[float]:
        """Seconds since the last beat, or None if it never beat."""
        with self._lock:
            last = self._beats.get(component)
        return None if last is None else time.monotonic() - last

    def ages(self) -> Dict[str, float]:
        with self._lock:
            beats = dict(self._beats)
        now = time.monotonic()
        return {k: now - v for k, v in beats.items()}

    def export_ages(self) -> None:
        gauge = self._registry.gauge(
            "stoix_tpu_sebulba_heartbeat_age_seconds",
            "Seconds since each Sebulba component last completed work")
        for component, age in self.ages().items():
            gauge.set(age, {"component": component})


def describe_age(age: Optional[float]) -> str:
    return "never beat" if age is None else f"last beat {age:.1f}s ago"


class StallDetector:
    """Heartbeat-age verdicts; a component older than `stale_after_s` counts
    as stalled."""

    def __init__(self, board: HeartbeatBoard, stale_after_s: float = 30.0):
        self.board = board
        self.stale_after_s = float(stale_after_s)

    def diagnose(self, waiting_on: Optional[str] = None) -> str:
        """One-line verdict naming the starved component. `waiting_on` is the
        component the caller timed out waiting FOR (e.g. "actor-3")."""
        self.board.export_ages()
        ages = self.board.ages()
        if waiting_on is not None:
            age = ages.get(waiting_on)
            if age is None:
                return (f"{waiting_on} never produced work — it likely crashed "
                        f"during setup (check its thread's traceback)")
            if age > self.stale_after_s:
                return (f"{waiting_on} stalled ({describe_age(age)}): it stopped "
                        f"producing — dead env backend or starved of params")
            return (f"{waiting_on} is alive ({describe_age(age)}) but its hand-off "
                    f"queue did not deliver — pipeline wedged (consumer not "
                    f"draining, or payload stuck in device transfer)")
        stalled = {k: v for k, v in ages.items() if v > self.stale_after_s}
        if not stalled:
            return "all components beating within threshold"
        worst = max(stalled, key=lambda k: stalled[k])
        return f"{worst} stalled ({describe_age(stalled[worst])})"



class HealthMonitor:
    """Process-wide aggregation of liveness sources for `/healthz`: heartbeat
    boards (the Anakin window loop, Sebulba's pipelines) judged through
    StallDetector thresholds, check callables, and the watchdog's verdict
    (any `stoix_tpu_watchdog_stalls_total` increment since the run started).

    `reset()` is the relaunch seam: `observability.configure()` calls it at
    every run's start, so a fresh run begins with no boards, no checks and a
    re-based watchdog count."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry or get_registry()
        self._lock = threading.Lock()
        self._boards: Dict[str, Tuple[HeartbeatBoard, float]] = {}
        self._checks: Dict[str, Callable[[], Optional[str]]] = {}
        self._stall_base = self._watchdog_stalls()

    def _watchdog_stalls(self) -> float:
        counter = self._registry.counter("stoix_tpu_watchdog_stalls_total",
                                         "Watchdog deadline expirations, by stage")
        return float(sum(value for _, value in counter.labels_and_values()))

    def register_board(self, name: str, board: HeartbeatBoard,
                       stale_after_s: float = 60.0) -> None:
        with self._lock:
            self._boards[name] = (board, float(stale_after_s))

    def register_check(self, name: str, check: Callable[[], Optional[str]]) -> None:
        """`check()` returns None when healthy, else a one-line problem."""
        with self._lock:
            self._checks[name] = check

    def unregister(self, name: str) -> None:
        with self._lock:
            self._boards.pop(name, None)
            self._checks.pop(name, None)

    def reset(self) -> None:
        with self._lock:
            self._boards.clear()
            self._checks.clear()
        self._stall_base = self._watchdog_stalls()

    def verdict(self) -> Tuple[bool, str]:
        """(healthy, one-page detail). Unhealthy when a registered board has
        a component older than its threshold, a check reports a problem, or
        a watchdog stage blew its deadline this run. A component that never
        beat is not unhealthy: the first build precedes the first beat."""
        with self._lock:
            boards = dict(self._boards)
            checks = dict(self._checks)
        problems: List[str] = []
        lines: List[str] = []
        for name, (board, stale_after_s) in sorted(boards.items()):
            detector = StallDetector(board, stale_after_s=stale_after_s)
            ages = board.ages()
            if any(age > stale_after_s for age in ages.values()):
                problems.append(f"{name}: {detector.diagnose()}")
            summary = ", ".join(f"{component}={describe_age(age)}"
                                for component, age in sorted(ages.items()))
            lines.append(f"{name}: {summary or 'no beats yet'}")
        for name, check in sorted(checks.items()):
            problem = check()
            if problem is not None:
                problems.append(f"{name}: {problem}")
            lines.append(f"{name}: {problem or 'ok'}")
        stalls = self._watchdog_stalls() - self._stall_base
        if stalls > 0:
            problems.append(f"watchdog: {int(stalls)} stage deadline(s) blown this run")
        if problems:
            return False, "\n".join(problems)
        return True, "ok\n" + "\n".join(lines) if lines else "ok"


_monitor_lock = threading.Lock()
_monitor: Optional[HealthMonitor] = None


def get_health_monitor() -> HealthMonitor:
    """The process-wide monitor serving `/healthz`."""
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = HealthMonitor()
        return _monitor


class ActorStarvationError(RuntimeError):
    """Raised by OnPolicyPipeline.collect_rollouts in place of a bare
    queue.Empty: carries WHICH actor timed out and the heartbeat verdict."""

    def __init__(self, actor_id: int, timeout: float, verdict: str, age: Optional[float]):
        self.actor_id = actor_id
        self.heartbeat_age = age
        super().__init__(
            f"collect_rollouts timed out after {timeout:.0f}s waiting for "
            f"actor-{actor_id} ({describe_age(age)}): {verdict}")
