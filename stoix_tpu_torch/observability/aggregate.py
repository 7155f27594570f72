"""Fleet-wide metrics over the fleet's key-value store (counterpart of
stoix_tpu/observability/aggregate.py: the same encoding and page).

Each process's publisher thread serializes its registry snapshot to JSON and
`put`s it at `ometrics/<process_index>` through the fleet backend's protocol
(parallel/distributed.py::FleetStoreBackend, or a FakeFleetBackend in tests),
one bounded blob a process an interval, off the training path. Any process
folds the newest blob of every peer into one Prometheus page with a
`host="<process_index>"` label on every series, served at `/metrics/fleet`
(httpz.py). Rendering reuses exporters.py's formatting: there is no second
exposition-format implementation.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

from stoix_tpu_torch.observability.exporters import _fmt_labels, _fmt_value
from stoix_tpu_torch.observability.registry import MetricsRegistry, get_registry

# Key prefix inside the fleet backend's own namespace (the backend already
# prefixes "stoix_tpu/fleet/"): distinct from hb/, vote/ and barrier/ keys.
_KEY_PREFIX = "ometrics/"


def encode_snapshot(snapshot: Dict[str, Any]) -> str:
    """JSON-safe encoding of `MetricsRegistry.snapshot()`: histogram bucket
    dicts keyed by float bounds become [bound, count] pair lists (JSON
    object keys must be strings; round-tripping through str would corrupt
    the +Inf bound)."""
    families: Dict[str, Any] = {}
    for name, family in snapshot.items():
        series_out: List[Dict[str, Any]] = []
        for series in family["series"]:
            entry: Dict[str, Any] = {"labels": dict(series["labels"])}
            if family["kind"] == "histogram":
                entry["summary"] = dict(series["summary"])
                entry["buckets"] = sorted(
                    [bound, count] for bound, count in series["buckets"].items()
                )
            else:
                entry["value"] = series["value"]
            series_out.append(entry)
        families[name] = {
            "kind": family["kind"],
            "help": family["help"],
            "series": series_out,
        }
    return json.dumps(families)


def decode_snapshot(blob: str) -> Dict[str, Any]:
    families = json.loads(blob)
    for family in families.values():
        if family["kind"] == "histogram":
            for series in family["series"]:
                series["buckets"] = {
                    float(bound): count for bound, count in series["buckets"]
                }
    return families


def render_fleet_text(snapshots: Dict[int, Dict[str, Any]]) -> str:
    """Fold per-host snapshots into one exposition page: every series gains
    a `host` label, `# HELP`/`# TYPE` still emitted once per family (first
    host's help text wins — the code is identical fleet-wide)."""
    merged: Dict[str, Dict[str, Any]] = {}
    for host in sorted(snapshots):
        for name, family in snapshots[host].items():
            slot = merged.setdefault(
                name, {"kind": family["kind"], "help": family["help"], "series": []}
            )
            for series in family["series"]:
                slot["series"].append((host, series))
    lines: List[str] = []
    for name, family in sorted(merged.items()):
        if family["help"]:
            lines.append(f"# HELP {name} {family['help']}")
        lines.append(f"# TYPE {name} {family['kind']}")
        for host, series in family["series"]:
            labels = series["labels"]
            host_label = {"host": str(host)}
            if family["kind"] == "histogram":
                for bound, count in sorted(series["buckets"].items()):
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, {**host_label, 'le': _fmt_value(bound)})}"
                        f" {count}"
                    )
                lines.append(
                    f"{name}_sum{_fmt_labels(labels, host_label)} "
                    f"{_fmt_value(series['summary']['sum'])}"
                )
                lines.append(
                    f"{name}_count{_fmt_labels(labels, host_label)} "
                    f"{series['summary']['count']}"
                )
            else:
                lines.append(
                    f"{name}{_fmt_labels(labels, host_label)} "
                    f"{_fmt_value(series['value'])}"
                )
    return "\n".join(lines) + "\n"


class FleetMetricsAggregator:
    """Publish this host's snapshot on a cadence; fold every host's newest
    blob on demand. `backend` speaks the fleet KV protocol (put/try_get) —
    the live FleetStoreBackend or a FakeFleetBackend view in tests."""

    def __init__(
        self,
        backend: Any,
        process_index: int,
        num_processes: int,
        registry: Optional[MetricsRegistry] = None,
        interval_s: float = 10.0,
    ):
        self._backend = backend
        self._process_index = int(process_index)
        self._num_processes = int(num_processes)
        self._registry = registry or get_registry()
        self._interval_s = max(0.5, float(interval_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def publish_once(self) -> None:
        """One snapshot -> KV put. Overwrites the previous blob (the fold
        only ever wants the newest); size is bounded by the registry's live
        series count, never by run length."""
        blob = encode_snapshot(self._registry.snapshot())
        self._backend.put(f"{_KEY_PREFIX}{self._process_index}", blob)

    def _publisher_loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            self.publish_once()

    def start(self) -> "FleetMetricsAggregator":
        if self._thread is not None:
            return self
        self.publish_once()
        self._thread = threading.Thread(
            target=self._publisher_loop,
            name="stoix-tpu-torch-metrics-aggregate",
            daemon=True,
        )
        self._thread.start()
        return self

    def render(self) -> str:
        """The fleet-wide /metrics page: this host's LIVE snapshot plus the
        newest published blob from every peer (a peer that has not published
        yet is simply absent — the page never blocks on the KV store)."""
        # decode(encode(...)) normalizes this host's live snapshot into the
        # same bucket-list-free shape the peers' decoded blobs have.
        snapshots: Dict[int, Dict[str, Any]] = {
            self._process_index: decode_snapshot(
                encode_snapshot(self._registry.snapshot())
            )
        }
        for peer in range(self._num_processes):
            if peer == self._process_index:
                continue
            blob = self._backend.try_get(f"{_KEY_PREFIX}{peer}")
            if blob is None:
                continue
            try:
                snapshots[peer] = decode_snapshot(blob)
            except (ValueError, KeyError, TypeError):
                continue  # torn/old blob: skip this peer for this render
        return render_fleet_text(snapshots)

    def close(self, join_timeout: float = 5.0) -> None:
        self._stop.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(join_timeout)


def aggregator_from_fleet(
    fleet_coord: Any, interval_s: float = 10.0
) -> Optional[FleetMetricsAggregator]:
    """Build an aggregator riding an active FleetCoordinator's KV backend.
    None when the coordinator has no backend (single-process fleet) — the
    local /metrics page already tells the whole story there."""
    backend = getattr(fleet_coord, "_backend", None)
    if backend is None:
        return None
    return FleetMetricsAggregator(
        backend,
        process_index=int(fleet_coord.process_index),
        num_processes=int(fleet_coord.process_count),
        interval_s=interval_s,
    )
