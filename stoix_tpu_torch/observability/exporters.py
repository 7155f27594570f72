"""Registry exporters (counterpart of stoix_tpu/observability/exporters.py,
the same text): Prometheus text exposition (format 0.0.4, written
atomically) and a JSONL snapshot log, one flattened row per call
(`{"t": step, "time": unix, "metrics": {name{k=v,...}: value}}`). Both
render `MetricsRegistry.snapshot()`, so an export never holds an
instrument's lock while it writes a file.
"""

from __future__ import annotations

import json
import math
import os
import re
import time
from typing import Any, Dict, Optional

from stoix_tpu_torch.observability.registry import MetricsRegistry, get_registry

# Prometheus exposition-format identifier grammar (text format 0.0.4):
# metric names additionally allow ':' (recording-rule convention).
_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_METRIC_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_]")


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v != v:  # NaN
        return "NaN"
    return repr(float(v))


def sanitize_metric_name(name: str) -> str:
    """Spec-valid metric name: invalid characters collapse to '_' (and a
    leading digit gets a '_' prefix) rather than raising — an exporter must
    render whatever the process registered, not crash the scrape."""
    name = str(name)
    if _METRIC_NAME_RE.match(name):
        return name
    name = _METRIC_BAD_CHARS.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def sanitize_label_name(name: str) -> str:
    name = str(name)
    if _LABEL_NAME_RE.match(name):
        return name
    name = _LABEL_BAD_CHARS.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _escape_label_value(value: str) -> str:
    # Escaping order matters: backslash first, then quote and newline —
    # the three characters the spec requires escaped in label values.
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    # HELP text escapes backslash and newline only (quotes are legal there).
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: Dict[str, str], extra: Optional[Dict[str, str]] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        '%s="%s"' % (sanitize_label_name(k), _escape_label_value(v))
        for k, v in sorted(merged.items())
    )
    return "{%s}" % inner


def to_prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    registry = registry or get_registry()
    lines = []
    for raw_name, family in sorted(registry.snapshot().items()):
        name = sanitize_metric_name(raw_name)
        # HELP then TYPE, emitted exactly once per family — every labeled
        # child series of the family renders below the single header pair.
        if family["help"]:
            lines.append(f"# HELP {name} {_escape_help(family['help'])}")
        lines.append(f"# TYPE {name} {family['kind']}")
        for series in family["series"]:
            labels = series["labels"]
            if family["kind"] == "histogram":
                for bound, count in sorted(series["buckets"].items()):
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, {'le': _fmt_value(bound)})} {count}"
                    )
                lines.append(f"{name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(series['summary']['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} "
                             f"{series['summary']['count']}")
            else:
                lines.append(
                    f"{name}{_fmt_labels(labels)} {_fmt_value(series['value'])}"
                )
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, registry: Optional[MetricsRegistry] = None) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(to_prometheus_text(registry))
    os.replace(tmp, path)
    return path


def flatten_snapshot(snapshot: Dict[str, Any]) -> Dict[str, float]:
    """{name{k=v,...}: value} — histograms contribute _count/_sum/_mean/_max."""
    flat: Dict[str, float] = {}
    for name, family in snapshot.items():
        for series in family["series"]:
            labels = series["labels"]
            suffix = (
                "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"
                if labels
                else ""
            )
            if family["kind"] == "histogram":
                summary = series["summary"]
                flat[f"{name}_count{suffix}"] = float(summary["count"])
                flat[f"{name}_sum{suffix}"] = float(summary["sum"])
                if summary["count"]:
                    flat[f"{name}_mean{suffix}"] = float(summary["mean"])
                    flat[f"{name}_max{suffix}"] = float(summary["max"])
            else:
                flat[f"{name}{suffix}"] = float(series["value"])
    return flat


class JsonlMetricsWriter:
    """Append-mode JSONL snapshot log (one row per call, flushed so a killed
    run keeps everything written so far)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file = open(path, "a")
        self.path = path

    def write_snapshot(
        self, t: int, registry: Optional[MetricsRegistry] = None
    ) -> None:
        registry = registry or get_registry()
        row = {
            "t": int(t),
            "time": time.time(),
            "metrics": flatten_snapshot(registry.snapshot()),
        }
        self._file.write(json.dumps(row) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()
