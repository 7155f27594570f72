"""Chrome trace-event / Perfetto JSON export of the host span buffer
(counterpart of stoix_tpu/observability/trace_export.py, the same format and
checks): `{"traceEvents": [...]}` with complete events (`"ph": "X"`,
microsecond `ts`/`dur`) sorted by `ts` and thread-name metadata events
(`"ph": "M"`). The file loads in Perfetto beside a `torch.profiler` trace of
the same run.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from stoix_tpu_torch.observability.trace import TraceRecorder, get_recorder

# Single-process runs: one pid keeps all host threads in one Perfetto group.
_PID = os.getpid()


def to_chrome_trace(recorder: Optional[TraceRecorder] = None) -> Dict[str, Any]:
    recorder = recorder or get_recorder()
    events: List[Dict[str, Any]] = []
    for tid, name in sorted(recorder.thread_names().items()):
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": _PID,
                "tid": tid,
                "args": {"name": name},
            }
        )
    spans = sorted(recorder.events(), key=lambda e: e["ts"])
    for e in spans:
        event = {
            "name": e["name"],
            "ph": "X",
            "ts": e["ts"],
            "dur": e["dur"],
            "pid": _PID,
            "tid": e["tid"],
        }
        if e["args"]:
            event["args"] = e["args"]
        events.append(event)
    trace: Dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    if recorder.dropped:
        trace["metadata"] = {"dropped_events": recorder.dropped}
    return trace


def write_chrome_trace(path: str, recorder: Optional[TraceRecorder] = None) -> str:
    """Write the trace JSON; returns the path for log lines."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_chrome_trace(recorder), f)
    return path


def validate_chrome_trace(trace: Dict[str, Any]) -> List[str]:
    """Schema check used by tests and the telemetry self-check: returns a
    list of violations (empty = valid). Checks the invariants Perfetto
    actually relies on: every event has name/ph/pid/tid, complete events have
    numeric non-negative ts/dur, and complete events are ts-sorted."""
    problems: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    last_ts = None
    for i, e in enumerate(events):
        for field in ("name", "ph", "pid", "tid"):
            if field not in e:
                problems.append(f"event {i}: missing {field}")
        ph = e.get("ph")
        if ph not in ("X", "M", "B", "E", "i", "I"):
            problems.append(f"event {i}: unknown phase {ph!r}")
        if ph == "X":
            ts, dur = e.get("ts"), e.get("dur")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"event {i}: bad ts {ts!r}")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
            if isinstance(ts, (int, float)):
                if last_ts is not None and ts < last_ts:
                    problems.append(f"event {i}: ts {ts} < previous {last_ts} (unsorted)")
                last_ts = ts
    return problems
