"""Sebulba health (counterpart of stoix_tpu/observability/health.py's
`HeartbeatBoard`, `StallDetector` and `ActorStarvationError`): heartbeats per
component and a stall detector that NAMES the starved side instead of
surfacing an anonymous `queue.Empty`.

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
from typing import Dict, Optional

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


class ActorStarvationError(RuntimeError):
    """Raised by OnPolicyPipeline.collect_rollouts in place of a bare
    queue.Empty: carries WHICH actor timed out and the heartbeat verdict."""

    def __init__(self, actor_id: int, timeout: float, verdict: str, age: Optional[float]):
        self.actor_id = actor_id
        self.heartbeat_age = age
        super().__init__(
            f"collect_rollouts timed out after {timeout:.0f}s waiting for "
            f"actor-{actor_id} ({describe_age(age)}): {verdict}")
