"""Cross-process fleet coordination for multi-process runs (counterpart of
stoix_tpu/resilience/fleet.py: the same settings, flags, decisions, metric
names, messages, exit code and emergency-store format).

The per-process resilience of resilience/preemption.py, guards.py and
watchdog.py cannot see the collective failures of a multi-process run: one
preempted rank that drains and checkpoints alone leaves its peers hanging in
the next all-reduce, and a rank that freezes turns the whole job into a
silent collective until the scheduler kills it. This module is the net
across processes, on the `torch.distributed` store the process group already
uses (parallel/distributed.py::FleetStoreBackend), with an in-process fake
(`FakeFleetStore`) so every path runs in a unit test:

  * **Agreed stop decisions.** Per-process preemption and fault flags are
    combined at each eval-window boundary, so every process drains,
    checkpoints and exits at the same window. The Anakin runner carries a
    per-rank payload (`telemetry_for_fetch`: the stop-flag byte and the last
    window's wall time) in the window's existing metric gather, one slot a
    rank, at no extra collective; Sebulba exchanges window-indexed votes
    through the store (`agree_at_window`). Both use one rule
    (`FleetDecision`).
  * **Heartbeats and partition detection.** Each process publishes a
    heartbeat sequence number from a thread; a monitor thread turns a stale
    peer into a typed `FleetPartitionError` naming it, writes the local
    emergency checkpoint, interrupts the main thread and, after
    `exit_grace_s`, hard-exits with EXIT_CODE_FLEET_PARTITION (87). A main
    thread blocked in a collective whose peer is frozen sits in C++ (gloo's
    own timeout is half an hour), where the interrupt cannot reach it: the
    hard exit is what ends it.
  * **Straggler skew.** Per-process window wall times are exported as
    `stoix_tpu_fleet_*` gauges; a process slower than `skew_warn_ratio` times
    the fastest raises a typed `FleetStragglerWarning`.
  * **Deadline-guarded barriers.** `guarded_barrier` runs a store barrier
    under the watchdog (resilience/watchdog.py) with `FleetBarrierTimeout`
    as its error, so a peer that never arrives leaves a stack dump and a
    typed error instead of a hang.

The rescue snapshot never touches the device at partition time. Each window
the runner stages a HOST copy of the learner state (`stage_candidate`: every
tensor copied into a pinned buffer with `non_blocking`, a CUDA event after
the copies), confirms it once the window's metrics are on the host
(`confirm_candidate` waits on that event on the main thread), and the
monitor thread's `emergency_save` only writes numpy: a read of the card from
the monitor thread would queue behind the collective that never ends. Over
several processes a rank's own fields (`integrity.per_rank_fields`: its
generators, env state, timestep, buffers; a population's members' own, or
all its members when they are spread over ranks) are recorded as partial and not
saved, as the JAX package cannot read the shards of a dead peer's global
arrays; one process saves every leaf. The store's format is the JAX
package's: `<emergency_dir>/p<rank>/state.npz` and `fleet_manifest.json`
(`format`, `step`, `process_index`, `process_count`, `partial`, `casts`,
per-leaf sha256 `digests`), so a store written by either package reads in
the other. `restore_emergency` feeds it through the topology-elastic
placement (utils/checkpointing.py::place_host_leaves).

Everything sits behind `arch.fleet.enabled`; off (the default), no thread
starts, no key is written and the host loops are the same, bit for bit. The
coordinator draws from no generator, so on it is the same run too.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from stoix_tpu_torch.observability import flightrec, get_logger, get_registry
from stoix_tpu_torch.resilience import faultinject
from stoix_tpu_torch.resilience.errors import (
    FleetBarrierTimeout,
    FleetError,
    FleetPartitionError,
)
from stoix_tpu_torch.resilience.exit_codes import EXIT_CODE_FLEET_PARTITION

# Per-process stop-flag bits, combined at window boundaries: a nonzero flag
# anywhere means every process stops at that window.
FLAG_PREEMPT = 1  # SIGTERM/SIGINT observed on this process
FLAG_FAULT = 2  # a process-local unrecoverable fault
FLAG_PARTITION = 4  # this process's monitor already declared a partition
FLAG_CORRUPT = 8  # the integrity sentinel proved state corruption

MANIFEST_NAME = "fleet_manifest.json"
_STATE_FILE = "state.npz"
# numpy dtype kinds that np.savez round-trips; anything else (bfloat16) is
# stored as float32 and cast back to the template's dtype on restore.
_PORTABLE_KINDS = frozenset("biufc")


class FleetStragglerWarning(UserWarning):
    """Typed slow-process warning: one process's window wall time exceeded
    `skew_warn_ratio` times the fleet's fastest."""


class FleetSettings(NamedTuple):
    """The resolved `arch.fleet` config block (defaults applied)."""

    enabled: bool
    heartbeat_interval_s: float
    heartbeat_timeout_s: float
    monitor_poll_s: float
    barrier_deadline_s: float
    skew_warn_ratio: float
    exit_grace_s: float
    emergency_dir: str


def settings_from_config(config: Any) -> FleetSettings:
    cfg = (config.get("arch") or {}).get("fleet") or {}
    return FleetSettings(
        enabled=bool(cfg.get("enabled", False)),
        heartbeat_interval_s=float(cfg.get("heartbeat_interval_s", 2.0)),
        heartbeat_timeout_s=float(cfg.get("heartbeat_timeout_s", 30.0)),
        monitor_poll_s=float(cfg.get("monitor_poll_s", 1.0)),
        barrier_deadline_s=float(cfg.get("barrier_deadline_s", 600.0)),
        skew_warn_ratio=float(cfg.get("skew_warn_ratio", 2.0)),
        exit_grace_s=float(cfg.get("exit_grace_s", 30.0)),
        emergency_dir=str(
            cfg.get("emergency_dir") or os.path.join("checkpoints", "fleet_emergency")
        ),
    )


# ---------------------------------------------------------------------------
# The in-process fake store (the live one is parallel/distributed.py's)
# ---------------------------------------------------------------------------


class FakeFleetStore:
    """Shared in-process stand-in for the fleet store: N `view()`s of one
    store behave like N processes' backends."""

    def __init__(self, num_processes: int):
        self.num_processes = int(num_processes)
        self._cond = threading.Condition()
        self._data: Dict[str, str] = {}
        self._barriers: Dict[str, set] = {}

    def view(self, process_index: int) -> "FakeFleetBackend":
        return FakeFleetBackend(self, process_index)

    def put(self, key: str, value: str) -> None:
        with self._cond:
            self._data[key] = str(value)
            self._cond.notify_all()

    def try_get(self, key: str) -> Optional[str]:
        with self._cond:
            return self._data.get(key)

    def get_blocking(self, key: str, timeout_s: float) -> Optional[str]:
        with self._cond:
            self._cond.wait_for(lambda: key in self._data, timeout=timeout_s)
            return self._data.get(key)

    def barrier(self, name: str, timeout_s: float, process_index: int) -> bool:
        with self._cond:
            arrived = self._barriers.setdefault(name, set())
            arrived.add(int(process_index))
            self._cond.notify_all()
            return self._cond.wait_for(
                lambda: len(self._barriers.get(name, ())) >= self.num_processes,
                timeout=timeout_s,
            )


class FakeFleetBackend:
    """One process's view of a FakeFleetStore (the backend protocol)."""

    def __init__(self, store: FakeFleetStore, process_index: int):
        self._store = store
        self.process_index = int(process_index)
        self.process_count = store.num_processes

    def put(self, key: str, value: str) -> None:
        self._store.put(key, value)

    def try_get(self, key: str) -> Optional[str]:
        return self._store.try_get(key)

    def get_blocking(self, key: str, timeout_s: float) -> Optional[str]:
        return self._store.get_blocking(key, timeout_s)

    def barrier(self, name: str, timeout_s: float) -> bool:
        return self._store.barrier(name, timeout_s, self.process_index)


# ---------------------------------------------------------------------------
# Decisions
# ---------------------------------------------------------------------------


def describe_flags(bits: int) -> str:
    names = []
    if bits & FLAG_PREEMPT:
        names.append("preempt")
    if bits & FLAG_FAULT:
        names.append("fault")
    if bits & FLAG_PARTITION:
        names.append("partition")
    if bits & FLAG_CORRUPT:
        names.append("corrupt")
    return "+".join(names) if names else "healthy"


class FleetDecision(NamedTuple):
    """The combined window-boundary verdict: the same on every process,
    because it is a pure function of the same exchanged flags."""

    stop: bool
    flags: Dict[int, int]  # process index -> flag bits

    @property
    def stopping_processes(self) -> List[int]:
        return sorted(p for p, f in self.flags.items() if f)

    def describe(self) -> str:
        if not self.stop:
            return "fleet healthy"
        parts = ", ".join(
            f"process {p}: {describe_flags(f)}" for p, f in sorted(self.flags.items()) if f
        )
        return f"fleet stop agreed ({parts})"


def _host(values: Any) -> np.ndarray:
    """A payload leaf as a flat numpy vector (a single process's payload is
    the rank's own tensor, ungathered)."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return np.asarray(values).reshape(-1)


def _slot_processes(count: int) -> List[int]:
    """The process of each slot of a gathered per-rank vector: the port's
    gathers put rank r's value in slot r."""
    return list(range(count))


# ---------------------------------------------------------------------------
# The rescue snapshot: a host copy of the learner state
# ---------------------------------------------------------------------------


class _HostSnapshot:
    """One staged window: {key: host value} (pinned tensors, numpy arrays,
    generator states, plain scalars), the keys recorded as partial, and the
    CUDA events around the device-to-host copies (None on the CPU)."""

    def __init__(self, values: Dict[str, Any], partial: List[str], events: Any, buffers: Any):
        self.values = values
        self.partial = partial
        self.events = events
        self.buffers = buffers  # the pinned buffer set it holds (None without a card)
        self.copy_ms: Optional[float] = None


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------


class FleetCoordinator:
    """This process's fleet membership: local stop flags, the heartbeat
    publisher and peer monitor threads, agreement, skew telemetry, and the
    local emergency checkpoint. Build it with `fleet_from_config`; `start()`
    before the host loop, `stop()` in its finally."""

    def __init__(
        self,
        settings: FleetSettings,
        backend: Optional[Any] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        interrupt_on_partition: bool = True,
    ):
        self.settings = settings
        self._backend = backend
        if process_index is None or process_count is None:
            if backend is not None:
                process_index = backend.process_index
                process_count = backend.process_count
            else:
                from stoix_tpu_torch.parallel.distributed import process_count as _count
                import torch.distributed as dist

                process_index = dist.get_rank() if dist.is_initialized() else 0
                process_count = _count()
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self._interrupt_on_partition = bool(interrupt_on_partition)

        self._flag_lock = threading.Lock()
        self._local_flags = 0
        self._last_wall: Optional[float] = None
        self._stop_notes: List[str] = []

        self._stop_event = threading.Event()
        self._publisher: Optional[threading.Thread] = None
        self._monitor: Optional[threading.Thread] = None

        self.partition_event = threading.Event()
        self._partition_error: Optional[FleetPartitionError] = None
        self._exit_timer: Optional[threading.Timer] = None

        self._rescue_lock = threading.Lock()
        self._candidates: Dict[int, _HostSnapshot] = {}
        self._confirmed: Optional[Tuple[int, _HostSnapshot]] = None
        self._saving: Optional[_HostSnapshot] = None
        self._saved_path: Optional[str] = None
        self._buffer_sets: List[Dict[str, torch.Tensor]] = []
        # The host copy's cost a window: the device time of the copies (ms,
        # from the CUDA events) and the bytes they moved.
        self.rescue_stats: Dict[str, Any] = {"staged": 0, "confirmed": 0, "bytes": 0,
                                             "copy_ms": []}

        self._prev_excepthook = None
        self._log = get_logger("stoix_tpu_torch.resilience")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetCoordinator":
        self._install_excepthook()
        if self._backend is not None and self.process_count > 1:
            self._backend.put(f"hb/{self.process_index}", "0")
            self._publisher = threading.Thread(
                target=self._publisher_loop, name="fleet-heartbeat", daemon=True
            )
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="fleet-monitor", daemon=True
            )
            self._publisher.start()
            self._monitor.start()
            self._log.info(
                "[fleet] coordination live: process %d/%d, heartbeat every "
                "%.1fs, peer deadline %.1fs",
                self.process_index, self.process_count,
                self.settings.heartbeat_interval_s,
                self.settings.heartbeat_timeout_s,
            )
        return self

    def stop(self) -> None:
        self._stop_event.set()
        for thread in (self._publisher, self._monitor):
            if thread is not None:
                thread.join(timeout=5.0)
        self._publisher = self._monitor = None
        # A main thread that reached this stop() has escaped any dead
        # collective: the hard-exit timer's one job is done.
        if self._exit_timer is not None:
            self._exit_timer.cancel()
        # Across a partition the hook stays: the FleetPartitionError leaving
        # the host loop after this stop() is what it turns into exit 87.
        if not self.partition_event.is_set():
            self._restore_excepthook()

    def __enter__(self) -> "FleetCoordinator":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()

    # -- local flags ----------------------------------------------------------
    def request_stop(self, flag: int, note: str = "") -> None:
        """Record a process-local stop reason (idempotent). The fleet acts on
        it at the NEXT window-boundary agreement, so all processes act
        together."""
        with self._flag_lock:
            already = bool(self._local_flags & flag)
            self._local_flags |= int(flag)
            if note:
                self._stop_notes.append(note)
        if not already:
            get_registry().counter(
                "stoix_tpu_fleet_stop_requests_total",
                "Host-local fleet stop requests, by reason",
            ).inc(labels={"reason": describe_flags(flag)})
            self._log.warning(
                "[fleet] process %d requesting fleet stop (%s)%s — peers will "
                "agree at the next window boundary",
                self.process_index, describe_flags(flag),
                f": {note}" if note else "",
            )

    @property
    def local_flags(self) -> int:
        with self._flag_lock:
            return self._local_flags

    # -- agreement + telemetry in the window's gather (Anakin) ----------------
    def note_window_wall(self, wall_s: float) -> None:
        """Record this process's most recent window wall time; the NEXT
        `telemetry_for_fetch` carries it. Through the coordinator's state,
        not a gather of its own: every rank must issue the same sequence of
        collectives, and a host-side gather between the learner's
        collectives is the mismatched-op failure gloo punishes."""
        with self._flag_lock:
            self._last_wall = float(wall_s)

    def telemetry_for_fetch(self, device: Any = "cpu") -> Dict[str, torch.Tensor]:
        """This rank's slot of the fleet payload the runner adds to the
        window's metric gather: the stop-flag byte (agreement) and the most
        recent window wall time (skew, NaN before the first). Gathered,
        every rank holds every rank's values, one slot a rank."""
        with self._flag_lock:
            last_wall = self._last_wall
        flag = torch.tensor([self.local_flags], dtype=torch.uint8, device=device)
        wall = torch.tensor([np.nan if last_wall is None else last_wall],
                            dtype=torch.float32, device=device)
        return {"flags": flag, "wall": wall}

    def _per_process(self, values: Any, mesh: Any = None) -> Dict[int, float]:
        """Fold a gathered per-rank vector into {process: value}."""
        flat = _host(values)
        if mesh is None or self.process_count == 1:
            return {self.process_index: flat.max(initial=0)}
        per_process: Dict[int, float] = {}
        for p, value in zip(_slot_processes(flat.size), flat):
            per_process[p] = max(per_process.get(p, value), value)
        return per_process

    def decide_from_fetch(self, payload: Any, mesh: Any = None) -> FleetDecision:
        """Combine a gathered `telemetry_for_fetch` payload (or a bare flag
        vector) into the fleet decision: a pure function of data every rank
        holds, so every rank computes the same verdict."""
        flags = payload["flags"] if isinstance(payload, dict) else payload
        values = _host(flags)
        if mesh is None or self.process_count == 1:
            per_process = {self.process_index: int(values.max(initial=0))}
        else:
            per_process: Dict[int, int] = {}
            for p, value in zip(_slot_processes(values.size), values):
                per_process[p] = per_process.get(p, 0) | int(value)
        return FleetDecision(any(per_process.values()), per_process)

    def skew_from_fetch(self, payload: Any, mesh: Any, window_idx: int) -> Optional[float]:
        """Export the straggler skew from a gathered payload. Returns the
        slowest/fastest ratio, or None while any process has not reported a
        wall time yet (the first window carries NaN)."""
        if not isinstance(payload, dict) or "wall" not in payload:
            return None
        walls_by_process = self._per_process(payload["wall"], mesh)
        walls = {p: float(w) for p, w in walls_by_process.items()}
        if any(np.isnan(w) for w in walls.values()):
            return None
        return self._export_skew(walls, window_idx)

    # -- agreement: store votes (Sebulba) ---------------------------------------
    def agree_at_window(self, window_idx: int, timeout_s: Optional[float] = None) -> FleetDecision:
        """Window-indexed vote exchange through the store: every process puts
        its flags under `vote/<window>/<pid>`, then reads every peer's vote
        for the same window with a bounded wait. Every process decides from
        the same votes, so all stop at the same window; a peer that never
        votes within the deadline is a partition."""
        flags = self.local_flags
        if self._backend is None or self.process_count == 1:
            return FleetDecision(flags != 0, {self.process_index: flags})
        deadline = (
            float(timeout_s) if timeout_s is not None
            else self.settings.barrier_deadline_s
        )
        self._backend.put(f"vote/{int(window_idx)}/{self.process_index}", str(flags))
        votes: Dict[int, int] = {}
        missing: List[int] = []
        for p in range(self.process_count):
            raw = self._backend.get_blocking(f"vote/{int(window_idx)}/{p}", deadline)
            if raw is None:
                missing.append(p)
            else:
                votes[p] = int(raw)
        if missing:
            raise self._declare_partition(
                missing, deadline, detail=f"no agreement vote for window {window_idx}"
            )
        return FleetDecision(any(votes.values()), votes)

    # -- heartbeats + partition detection -------------------------------------
    def _publisher_loop(self) -> None:
        seq = 0
        while not self._stop_event.wait(self.settings.heartbeat_interval_s):
            seq += 1
            try:
                self._backend.put(f"hb/{self.process_index}", str(seq))
            # A failed beat must not kill the publisher: peers see this
            # process stale, which is the signal.
            except Exception as exc:  # noqa: BLE001
                self._log.warning("[fleet] heartbeat publish failed: %s", exc)

    def _monitor_loop(self) -> None:
        peers = [p for p in range(self.process_count) if p != self.process_index]
        last_value: Dict[int, Optional[str]] = {p: None for p in peers}
        started = time.monotonic()
        last_change: Dict[int, float] = {p: started for p in peers}
        age_gauge = get_registry().gauge(
            "stoix_tpu_fleet_heartbeat_age_seconds",
            "Seconds since each peer process's fleet heartbeat last advanced",
        )
        while not self._stop_event.wait(self.settings.monitor_poll_s):
            now = time.monotonic()
            stale: List[int] = []
            for p in peers:
                value = self._backend.try_get(f"hb/{p}")
                if value is not None and value != last_value[p]:
                    last_value[p] = value
                    last_change[p] = now
                age = now - last_change[p]
                age_gauge.set(age, {"process": str(p)})
                if age > self.settings.heartbeat_timeout_s:
                    stale.append(p)
            if stale:
                self._on_partition(stale)
                return

    def _declare_partition(self, missing: List[int], deadline_s: float,
                           detail: str) -> FleetPartitionError:
        """Record a partition verdict (idempotent) and return the typed
        error. Shared by the monitor thread and the vote path."""
        with self._flag_lock:
            self._local_flags |= FLAG_PARTITION
        if self._partition_error is None:
            self._partition_error = FleetPartitionError(missing, deadline_s, detail)
            get_registry().counter(
                "stoix_tpu_fleet_partitions_total",
                "Fleet partitions declared by this process",
            ).inc()
            self.partition_event.set()
            self._log.error(
                "[fleet] %s: %s",
                type(self._partition_error).__name__, self._partition_error,
            )
            flightrec.get_flight_recorder().record(
                "fleet_partition", missing=list(missing), deadline_s=float(deadline_s),
                detail=detail,
            )
        return self._partition_error

    def _on_partition(self, stale: List[int]) -> None:
        """Monitor-thread partition handler: declare, rescue-save (host
        memory only), interrupt the main thread, and arm the hard exit."""
        self._declare_partition(
            stale, self.settings.heartbeat_timeout_s, detail="heartbeat silent"
        )
        try:
            self.emergency_save()
        # The exit path goes on to the interrupt and the hard exit.
        except Exception as exc:  # noqa: BLE001
            self._log.error("[fleet] emergency save failed: %s", exc)
        if self._interrupt_on_partition:
            if self.settings.exit_grace_s > 0:
                self._exit_timer = threading.Timer(
                    self.settings.exit_grace_s, self._hard_exit
                )
                self._exit_timer.daemon = True
                self._exit_timer.start()
            import _thread

            _thread.interrupt_main()

    def _dump_flight_record(self, reason: str) -> None:
        """The rc-87 flight record, beside the emergency store. Only the
        paths where the process dies with the fleet code dump it."""
        flightrec.dump_flight_record(
            self.settings.emergency_dir,
            reason=reason,
            exit_code=EXIT_CODE_FLEET_PARTITION,
        )

    def _hard_exit(self) -> None:
        self._log.error(
            "[fleet] main thread still wedged %.0fs after the partition was "
            "declared (dead collective is uninterruptible) — hard exit %d",
            self.settings.exit_grace_s, EXIT_CODE_FLEET_PARTITION,
        )
        self._dump_flight_record(
            f"fleet partition hard exit: {self._partition_error}"
        )
        sys.stderr.flush()
        os._exit(EXIT_CODE_FLEET_PARTITION)

    def check_partition(self) -> None:
        """Raise the monitor's verdict on the calling thread, if there is
        one. Host loops call it at window and update boundaries."""
        if self.partition_event.is_set() and self._partition_error is not None:
            raise self._partition_error

    @property
    def partition_error(self) -> Optional[FleetPartitionError]:
        return self._partition_error

    # -- exit-code translation ------------------------------------------------
    def _install_excepthook(self) -> None:
        prev = sys.excepthook
        self._prev_excepthook = prev

        def hook(exc_type, exc, tb):
            prev(exc_type, exc, tb)
            if isinstance(exc, FleetError):
                self._dump_flight_record(f"fleet partition: {exc}")
                sys.stderr.flush()
                os._exit(EXIT_CODE_FLEET_PARTITION)

        self._hook = hook
        sys.excepthook = hook

    def _restore_excepthook(self) -> None:
        # Only while the installed hook is still ours: the integrity
        # sentinel's rc-88 hook may have chained on top since.
        if self._prev_excepthook is not None and sys.excepthook is getattr(
            self, "_hook", None
        ):
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None

    # -- straggler skew telemetry ---------------------------------------------
    def observe_window_wall(self, window_idx: int, wall_s: float) -> Optional[float]:
        """Exchange this window's wall time with every peer through
        `process_allgather` and export the skew (None with one process). The
        host-side transport, for Sebulba's learner loop, which runs no
        collective of its own between processes; the Anakin runner carries
        its walls in the window's gather instead."""
        if self.process_count == 1:
            get_registry().gauge(
                "stoix_tpu_fleet_window_wall_seconds",
                "Per-host wall time of the most recent eval window",
            ).set(float(wall_s), {"process": str(self.process_index)})
            return None
        from stoix_tpu_torch.parallel import process_allgather

        walls = process_allgather(
            torch.tensor([float(wall_s)], dtype=torch.float64)).numpy().reshape(-1)
        return self._export_skew({p: float(w) for p, w in enumerate(walls)}, window_idx)

    def _export_skew(self, walls: Dict[int, float], window_idx: int) -> Optional[float]:
        """Export per-process wall gauges and the max/min skew ratio; a
        process slower than `skew_warn_ratio` times the fastest warns with
        the typed FleetStragglerWarning."""
        registry = get_registry()
        wall_gauge = registry.gauge(
            "stoix_tpu_fleet_window_wall_seconds",
            "Per-host wall time of the most recent eval window",
        )
        for p, wall in walls.items():
            wall_gauge.set(wall, {"process": str(p)})
        if len(walls) < 2:
            return None
        fastest = min(walls.values())
        slowest = max(walls.values())
        ratio = slowest / fastest if fastest > 0 else 1.0
        registry.gauge(
            "stoix_tpu_fleet_window_skew_ratio",
            "Slowest-host / fastest-host wall-time ratio for the most recent window",
        ).set(ratio)
        if ratio > self.settings.skew_warn_ratio:
            straggler = max(walls, key=lambda p: walls[p])
            registry.counter(
                "stoix_tpu_fleet_straggler_warnings_total",
                "Windows whose host wall-time skew exceeded skew_warn_ratio",
            ).inc(labels={"process": str(straggler)})
            message = (
                f"window {window_idx}: process {straggler} is a straggler — "
                f"{slowest:.2f}s vs fastest {fastest:.2f}s "
                f"({ratio:.1f}x > skew_warn_ratio {self.settings.skew_warn_ratio:.1f}); "
                f"the lockstep all-reduce runs at the slowest host's pace"
            )
            warnings.warn(FleetStragglerWarning(message), stacklevel=2)
            self._log.warning("[fleet] %s", message)
        return ratio

    # -- deadline-guarded barriers --------------------------------------------
    def barrier(self, name: str, deadline_s: Optional[float] = None) -> None:
        deadline = (
            float(deadline_s) if deadline_s is not None
            else self.settings.barrier_deadline_s
        )
        guarded_barrier(name, self._backend, deadline, exit_grace_s=self.settings.exit_grace_s)

    # -- the rescue snapshot ----------------------------------------------------
    def _free_buffers(self) -> Optional[Dict[str, torch.Tensor]]:
        """A pinned buffer set no staged, confirmed or saving snapshot holds."""
        held = {id(s.buffers) for s in (*self._candidates.values(),
                                         *([self._confirmed[1]] if self._confirmed else []),
                                         *([self._saving] if self._saving else []))}
        for buffers in self._buffer_sets:
            if id(buffers) not in held:
                return buffers
        return None

    def stage_candidate(self, step: int, state: Any) -> None:
        """Stage a host copy of the learner state for window `step`: card
        tensors go into pinned buffers with `non_blocking` copies enqueued
        behind the window's learn step, a CUDA event after them; CPU tensors,
        generator states and scalars are copied at once. `confirm_candidate`
        promotes it once the window's metrics are on the host. Over several
        processes a rank's own fields are recorded as partial."""
        from stoix_tpu_torch.resilience.integrity import is_rank_bound, per_rank_fields
        from stoix_tpu_torch.utils.checkpointing import flatten_state

        rank_bound = per_rank_fields(state) if self.process_count > 1 else set()
        leaves = list(flatten_state(state))
        on_card = [(("/".join(path)), leaf) for path, leaf in leaves
                   if isinstance(leaf, torch.Tensor) and leaf.is_cuda
                   and not is_rank_bound(path, rank_bound)]
        with self._rescue_lock:
            buffers = None
            if on_card:
                buffers = self._free_buffers()
                if buffers is None:
                    buffers = {key: torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
                               for key, leaf in on_card}
                    self._buffer_sets.append(buffers)
        values: Dict[str, Any] = {}
        partial: List[str] = []
        events = None
        moved = 0
        if on_card:
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        for path, leaf in leaves:
            key = "/".join(path)
            if leaf is None:
                continue
            if is_rank_bound(path, rank_bound):
                partial.append(key)
                continue
            if isinstance(leaf, torch.Tensor):
                if leaf.is_cuda:
                    buffer = buffers[key]
                    buffer.copy_(leaf.detach(), non_blocking=True)
                    values[key] = buffer
                    moved += leaf.numel() * leaf.element_size()
                else:
                    values[key] = leaf.detach().clone()
            elif isinstance(leaf, torch.Generator):
                values[key] = leaf.get_state()
            elif isinstance(leaf, np.ndarray):
                values[key] = leaf.copy()
            else:
                values[key] = np.asarray(leaf)
        if events is not None:
            events[1].record()
        snapshot = _HostSnapshot(values, partial, events, buffers)
        with self._rescue_lock:
            self._candidates[int(step)] = snapshot
            while len(self._candidates) > 2:
                del self._candidates[min(self._candidates)]
            self.rescue_stats["staged"] += 1
            self.rescue_stats["bytes"] = moved

    def confirm_candidate(self, step: int) -> None:
        """Promote window `step`'s staged copy to the rescue snapshot, on the
        main thread once the window's metrics are on the host: its copies
        have run by then, and waiting on its event makes sure of it."""
        with self._rescue_lock:
            snapshot = self._candidates.get(int(step))
        if snapshot is None:
            return
        if snapshot.events is not None:
            snapshot.events[1].synchronize()
            snapshot.copy_ms = snapshot.events[0].elapsed_time(snapshot.events[1])
        with self._rescue_lock:
            self._confirmed = (int(step), snapshot)
            for stale in [s for s in self._candidates if s <= int(step)]:
                del self._candidates[stale]
            self.rescue_stats["confirmed"] += 1
            if snapshot.copy_ms is not None:
                self.rescue_stats["copy_ms"].append(snapshot.copy_ms)

    def emergency_save(self) -> Optional[str]:
        """Write the confirmed rescue snapshot to
        `<emergency_dir>/p<process_index>/` as state.npz and its manifest
        (idempotent; returns the directory, or None with nothing confirmed).
        Host memory only: it never touches a device."""
        with self._rescue_lock:
            if self._saved_path is not None:
                return self._saved_path
            staged = self._confirmed
            if staged is not None:
                self._saving = staged[1]
        if staged is None:
            self._log.warning(
                "[fleet] no confirmed rescue snapshot to save (partition "
                "before the first completed window?)"
            )
            return None
        step, snapshot = staged
        try:
            from stoix_tpu_torch.resilience import integrity

            directory = os.path.join(self.settings.emergency_dir, f"p{self.process_index}")
            os.makedirs(directory, exist_ok=True)
            arrays: Dict[str, np.ndarray] = {}
            casts: Dict[str, str] = {}
            for key, value in snapshot.values.items():
                if isinstance(value, torch.Tensor):
                    if value.dtype == torch.bfloat16:
                        casts[key] = "bfloat16"
                        value = value.float()
                    arr = value.numpy()
                else:
                    arr = np.asarray(value)
                    if arr.dtype.kind not in _PORTABLE_KINDS:
                        casts[key] = str(arr.dtype)
                        arr = arr.astype(np.float32)
                arrays[key] = arr
            # Per-leaf sha256 digests (integrity.py, the checkpoint sidecar's
            # helpers): a restore verifies every leaf's bytes.
            digests = integrity.digest_arrays(arrays)
            np.savez(os.path.join(directory, _STATE_FILE), **arrays)
            manifest = {
                "format": 1,
                "step": int(step),
                "process_index": self.process_index,
                "process_count": self.process_count,
                "partial": sorted(snapshot.partial),
                "casts": casts,
                "digests": digests,
            }
            tmp = os.path.join(directory, MANIFEST_NAME + ".tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1)
            os.replace(tmp, os.path.join(directory, MANIFEST_NAME))
        finally:
            with self._rescue_lock:
                self._saving = None
        with self._rescue_lock:
            self._saved_path = directory
        self._log.warning(
            "[fleet] local-shard emergency checkpoint secured: step %d, %d "
            "leaf(s) (%d topology-bound leaf(s) skipped) at %s — resume with "
            "logger.checkpointing.load_model=true "
            "logger.checkpointing.load_args.load_path=%s",
            step, len(arrays), len(snapshot.partial), directory, self.settings.emergency_dir,
        )
        return directory


def guarded_barrier(name: str, backend: Any, deadline_s: float, exit_grace_s: float = 0.0) -> None:
    """A cross-process barrier under a deadline watchdog: a peer that never
    arrives raises FleetBarrierTimeout, with an all-thread stack dump,
    instead of hanging. The watchdog's deadline trails the backend's own a
    little, so the backend's bounded wait answers first when it can."""
    from stoix_tpu_torch.resilience.watchdog import Watchdog

    if backend is None:
        return
    with Watchdog(
        f"fleet_barrier:{name}",
        deadline_s + min(5.0, 0.25 * deadline_s + 0.5),
        hard_exit_grace_s=exit_grace_s,
        error_factory=lambda _stage, _deadline, dump: FleetBarrierTimeout(
            name, deadline_s, dump=dump
        ),
        exit_code=EXIT_CODE_FLEET_PARTITION,
    ):
        faultinject.maybe_barrier_wedge(name)
        if not backend.barrier(name, deadline_s):
            raise FleetBarrierTimeout(name, deadline_s)


# ---------------------------------------------------------------------------
# The emergency store's restore (through utils/checkpointing.place_host_leaves)
# ---------------------------------------------------------------------------


def _find_manifests(path: str) -> List[str]:
    direct = os.path.join(path, MANIFEST_NAME)
    if os.path.isfile(direct):
        return [direct]
    try:
        entries = os.listdir(path)
    except OSError:
        return []

    def _index(entry: str) -> Tuple[int, str]:
        # Numeric survivor order: 'p10' sorts after 'p2', so the lowest
        # process index wins the tie-break.
        if entry.startswith("p") and entry[1:].isdigit():
            return (int(entry[1:]), entry)
        return (1 << 30, entry)

    found = []
    for entry in sorted(entries, key=_index):
        candidate = os.path.join(path, entry, MANIFEST_NAME)
        if os.path.isfile(candidate):
            found.append(candidate)
    return found


def is_emergency_store(path: Any) -> bool:
    """Whether `path` holds a fleet emergency checkpoint (its own manifest,
    or per-survivor `p<N>/` subdirectories)."""
    return bool(path) and bool(_find_manifests(str(path)))


def emergency_step(path: str) -> Optional[int]:
    """The step in the winning survivor's manifest (None when `path` is not
    an emergency store); a read of the manifest only."""
    manifests = _find_manifests(str(path))
    if not manifests:
        return None
    try:
        with open(manifests[0]) as f:
            return int(json.load(f)["step"])
    except (OSError, ValueError, KeyError):
        return None


def read_emergency_raw(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, str], int]:
    """A fleet emergency store's host leaves with no template: (arrays keyed
    by slash-joined tree path, the manifest's storage-widening casts, the
    saved step). With several survivors' stores, the lowest process index
    wins. Every leaf is digest-checked against the manifest."""
    raw, manifest = _read_emergency(path)
    return raw, dict(manifest.get("casts") or {}), int(manifest["step"])


def _read_emergency(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """`read_emergency_raw`'s arrays, digest-checked, beside the whole
    manifest they were checked against."""
    manifests = _find_manifests(str(path))
    if not manifests:
        raise FileNotFoundError(f"no fleet emergency manifest under {path}")
    manifest_path = manifests[0]
    with open(manifest_path) as f:
        manifest = json.load(f)
    step = int(manifest["step"])
    directory = os.path.dirname(manifest_path)
    with np.load(os.path.join(directory, _STATE_FILE)) as data:
        raw = {key: data[key] for key in data.files}
    from stoix_tpu_torch.resilience import integrity
    from stoix_tpu_torch.resilience.errors import CheckpointIntegrityError

    mismatched = integrity.verify_digests(raw, dict(manifest.get("digests") or {}))
    if mismatched:
        raise CheckpointIntegrityError(
            step,
            f"emergency store {directory} failed sha256 verification for "
            f"{len(mismatched)} leaf(s): {', '.join(mismatched[:5])}"
            f"{'...' if len(mismatched) > 5 else ''}",
            kind="digest",
        )
    return raw, manifest


RESTORE_REPORT_NAME = "restore_report.json"


def read_restore_report(path: str) -> Optional[Dict[str, Any]]:
    """The report the latest `restore_emergency` over `path` left behind
    (None when none ran, or it is unreadable)."""
    try:
        with open(os.path.join(str(path), RESTORE_REPORT_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def restore_emergency(
    template: Any,
    path: str,
    raw_transform: Optional[Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]] = None,
) -> Tuple[Any, int]:
    """Restore a local emergency store into `template` through the
    topology-elastic placement (utils/checkpointing.place_host_leaves):
    matched leaves come back bit for bit, partial leaves (and
    shape-mismatched rank-bound ones) keep the template's fresh value, and
    over several processes every rank-bound leaf keeps this rank's own (the
    store is the lowest survivor's). Any other leaf whose shape differs is
    another state, not another topology, and raises
    CheckpointIntegrityError ('structure').

    `raw_transform` is the elastic seam: it rewrites the digest-verified
    host arrays before placement (the population's shrink and grow re-place
    the [P] member axis here, population/elastic.py). Leaves
    `restore_report.json` beside the store: the step, whether a transform
    ran, the sha256 of every leaf placed (after the transform, so with none
    they are the manifest's), what was reinitialized, and the restore's
    wall clock."""
    from stoix_tpu_torch.parallel.distributed import process_count
    from stoix_tpu_torch.resilience import integrity
    from stoix_tpu_torch.resilience.errors import CheckpointIntegrityError
    from stoix_tpu_torch.utils.checkpointing import flatten_state, place_host_leaves

    t_start = time.perf_counter()
    raw, manifest = _read_emergency(path)
    if raw_transform is not None:
        raw = dict(raw_transform(dict(raw)))
    casts = dict(manifest.get("casts") or {})
    step = int(manifest["step"])
    own = integrity.per_rank_fields(template)
    own_paths = [p for p, _ in flatten_state(template) if integrity.is_rank_bound(p, own)]
    rank_bound = set(manifest.get("partial") or ()) | {"/".join(p) for p in own_paths}
    for p, leaf in flatten_state(template):
        key = "/".join(p)
        if (isinstance(leaf, (torch.Tensor, np.ndarray)) and key in raw
                and key not in rank_bound and tuple(raw[key].shape) != tuple(leaf.shape)):
            raise CheckpointIntegrityError(
                step, f"leaf {key}: the store holds shape {tuple(raw[key].shape)}, the "
                f"learner state {tuple(leaf.shape)} (not a rank's own field)",
                kind="structure")
    placed_digests = integrity.digest_arrays(raw)
    # Storage-widened leaves back to the template's dtype (bfloat16 went to
    # disk as float32: lossless both ways).
    template_dtypes = {"/".join(p): leaf.dtype for p, leaf in flatten_state(template)
                       if isinstance(leaf, torch.Tensor)}
    placed: Dict[str, Any] = dict(raw)
    for key in casts:
        if key in raw and key in template_dtypes:
            placed[key] = torch.from_numpy(np.array(raw[key], order="C")).to(
                template_dtypes[key])
    raw_by_path = {tuple(key.split("/")): value for key, value in placed.items()}
    restored, matched, reinitialized, _reinit_keys = place_host_leaves(
        raw_by_path, template, step, allow_missing=True,
        keep=own_paths if process_count() > 1 else ())
    get_logger("stoix_tpu_torch.checkpoint").warning(
        "[fleet] emergency restore of step %d from %s: %d leaf(s) restored "
        "bit-identical, %d kept template initialization%s",
        step, path, matched, len(reinitialized),
        f" ({'; '.join(reinitialized)})" if reinitialized else "",
    )
    report = {
        "format": 1,
        "step": int(step),
        "source": str(path),
        "transformed": raw_transform is not None,
        "matched": int(matched),
        "reinitialized": list(reinitialized),
        "digests": placed_digests,
        "recovery_wall_s": time.perf_counter() - t_start,
        "unix_time": time.time(),
    }
    try:
        tmp = os.path.join(str(path), RESTORE_REPORT_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, os.path.join(str(path), RESTORE_REPORT_NAME))
    except OSError:
        get_logger("stoix_tpu_torch.checkpoint").warning(
            "[fleet] could not write %s next to %s", RESTORE_REPORT_NAME, path
        )
    return restored, step


def fleet_from_config(config: Any, backend: Optional[Any] = None) -> Optional[FleetCoordinator]:
    """A FleetCoordinator when `arch.fleet.enabled`, else None. `backend`
    injects a FakeFleetBackend in tests; by default the live store of the
    default process group (parallel/distributed.py::live_backend), which
    raises when a group of several processes has no reachable store. A
    single process coordinates with no store."""
    settings = settings_from_config(config)
    if not settings.enabled:
        return None
    if backend is None:
        from stoix_tpu_torch.parallel.distributed import live_backend

        backend = live_backend(config)
    return FleetCoordinator(settings, backend=backend)
