"""Crash flight recorder (counterpart of
stoix_tpu/observability/flightrec.py, the same record schema).

A bounded ring of small host-side event dicts: each completed window of a
run appends one (its phases, its integrity verdict), faults and watchdog
stalls append theirs, and `dump_flight_record()` serialises the ring
atomically as `flight_record.json` on the way down: next to the quarantine
file on the integrity sentinel's exit 88, under `checkpoints/` on the
watchdog's exit 86. Recording is host memory only (a lock and a deque
append), so it is always on and cannot change a run's trajectory.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional

SCHEMA_VERSION = 1

# Default directory for dump sites that have no better-scoped artifact
# location (the watchdog's rc-86 path): matches the quarantine default
# (`checkpoints/quarantine.json`) so every crash artifact lands together.
_DEFAULT_DUMP_DIR = "checkpoints"

FLIGHT_RECORD_FILENAME = "flight_record.json"


class FlightRecorder:
    """Thread-safe bounded ring of event dicts. `capacity` bounds memory:
    a record is ~a few hundred bytes, so the default keeps the last 64
    windows for well under 100 KiB."""

    def __init__(self, capacity: int = 64):
        self._lock = threading.Lock()
        self._events: Deque[Dict[str, Any]] = collections.deque(maxlen=int(capacity))
        self._context: Dict[str, Any] = {}
        self._seq = 0

    def set_context(self, **fields: Any) -> None:
        """Run-level fields (run id, architecture, system) merged into every
        dump's header — set once at run start, survives `clear()` of events
        only via re-set (a fresh run re-stamps its own context)."""
        with self._lock:
            self._context.update(fields)

    def record(self, kind: str, **fields: Any) -> None:
        """Append one event. `kind` names the record class ("window",
        "fault", "actor_crash", "integrity_verdict", ...)."""
        with self._lock:
            self._seq += 1
            event = {"seq": self._seq, "unix_time": time.time(), "kind": str(kind)}
            event.update(fields)
            self._events.append(event)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        """Fresh ring AND fresh context (per-run reset: a supervised
        relaunch / second in-process run must not dump the previous
        incarnation's windows as its own)."""
        with self._lock:
            self._events.clear()
            self._context.clear()
            self._seq = 0

    def dump(
        self, path: str, reason: str, exit_code: Optional[int] = None
    ) -> str:
        """Serialize the ring to `path` atomically (tmp + rename — a crash
        mid-dump never leaves a half-written record)."""
        with self._lock:
            record = {
                "version": SCHEMA_VERSION,
                "reason": str(reason),
                "exit_code": exit_code,
                "unix_time": time.time(),
                "context": dict(self._context),
                "events": list(self._events),
            }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=2, default=str)
        os.replace(tmp, path)
        return path


_lock = threading.Lock()
_recorder: Optional[FlightRecorder] = None


def get_flight_recorder() -> FlightRecorder:
    """Process-wide recorder (every subsystem appends to the same ring — a
    crash dump interleaves runner windows with supervisor/fault events in
    seq order)."""
    global _recorder
    with _lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def dump_flight_record(
    directory: Optional[str], reason: str, exit_code: Optional[int] = None
) -> Optional[str]:
    """Dump the process recorder as `<directory>/flight_record.json`.

    The entry point of the exit paths (integrity rc-88: the quarantine
    file's directory; watchdog rc-86: the default artifact directory): it
    must never raise on a path already going down, so filesystem failures
    degrade to None."""
    directory = directory or _DEFAULT_DUMP_DIR
    path = os.path.join(directory, FLIGHT_RECORD_FILENAME)
    try:
        return get_flight_recorder().dump(path, reason, exit_code)
    except OSError:
        return None


def validate_flight_record(record: Any) -> List[str]:
    """Schema check for tests/post-mortem tooling: [] means valid, otherwise
    a list of human-readable problems."""
    problems: List[str] = []
    if not isinstance(record, dict):
        return [f"record is {type(record).__name__}, expected dict"]
    if record.get("version") != SCHEMA_VERSION:
        problems.append(f"version {record.get('version')!r} != {SCHEMA_VERSION}")
    if not isinstance(record.get("reason"), str) or not record.get("reason"):
        problems.append("reason missing or empty")
    exit_code = record.get("exit_code")
    if exit_code is not None and not isinstance(exit_code, int):
        problems.append(f"exit_code {exit_code!r} is not int/None")
    if not isinstance(record.get("unix_time"), (int, float)):
        problems.append("unix_time missing")
    if not isinstance(record.get("context"), dict):
        problems.append("context missing or not a dict")
    events = record.get("events")
    if not isinstance(events, list):
        problems.append("events missing or not a list")
        return problems
    last_seq = 0
    for i, event in enumerate(events):
        if not isinstance(event, dict):
            problems.append(f"events[{i}] is not a dict")
            continue
        for field, kinds in (("seq", (int,)), ("unix_time", (int, float)),
                             ("kind", (str,))):
            if not isinstance(event.get(field), kinds):
                problems.append(f"events[{i}].{field} missing or wrong type")
        seq = event.get("seq")
        if isinstance(seq, int):
            if seq <= last_seq:
                problems.append(f"events[{i}].seq {seq} not strictly increasing")
            last_seq = seq
    return problems
