"""Deadline watchdogs for the first compile and the first window
(counterpart of stoix_tpu/resilience/watchdog.py).

A wedged device runtime does not crash: it absorbs the first build or the
first launch and never answers, leaving the main thread blocked in native
code that no Python signal handler can interrupt. `Watchdog` is a deadline
thread around a named stage:

  * On expiry it dumps the diagnosis, every thread's stack
    (`sys._current_frames`) and the metrics-registry snapshot, to the
    `stoix_tpu_torch.resilience` log and records a `watchdog_stall` event.
  * Then it raises `CompileStallError` in the protected section through
    `_thread.interrupt_main()`, which lands whenever the main thread runs
    Python (a build waiting on nvcc, an injected `slow_compile`).
  * A main thread blocked in native code (`torch.cuda.synchronize` on a
    wedged card) cannot be interrupted: with `hard_exit_grace_s > 0` a second
    timer dumps the flight record and `os._exit(EXIT_CODE_STALL)` (86) after
    that grace, so the job fails instead of burning its time limit. 0 (the
    default) leaves process death to the operator.

Stage begin and end beat the shared `HeartbeatBoard` (component
`host-<stage>`).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from stoix_tpu_torch.observability import HeartbeatBoard, flightrec, get_logger, get_registry
from stoix_tpu_torch.resilience.errors import CompileStallError

# The hard exit's code, from the registry (resilience/exit_codes.py).
from stoix_tpu_torch.resilience.exit_codes import EXIT_CODE_STALL

_board_lock = threading.Lock()
_board: Optional[HeartbeatBoard] = None


def get_watchdog_board() -> HeartbeatBoard:
    """Process-wide board the watchdogs beat (lazy: a HeartbeatBoard registers
    metrics, which must not happen at import time)."""
    global _board
    with _board_lock:
        if _board is None:
            _board = HeartbeatBoard()
        return _board


def dump_thread_stacks() -> str:
    """Every live thread's current stack, named — the core of the stall dump.
    Pure-Python introspection: safe to call from the watchdog thread while the
    main thread is blocked in native code (its last Python frame still shows
    WHICH native call it entered)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    chunks = []
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, "unknown")
        stack = "".join(traceback.format_stack(frame))
        chunks.append(f"--- thread {name} (ident {ident}) ---\n{stack}")
    return "\n".join(chunks)


def dump_state(stage: str) -> str:
    """Thread stacks + registry snapshot: everything a post-mortem needs from
    a wedged process, as one log-friendly string."""
    get_watchdog_board().export_ages()
    try:
        snapshot = json.dumps(get_registry().snapshot(), default=str, indent=2)
    except Exception as exc:  # noqa: BLE001 — a broken snapshot must not lose the stacks
        snapshot = f"<registry snapshot failed: {type(exc).__name__}: {exc}>"
    return (
        f"===== watchdog stall dump: stage '{stage}' =====\n"
        f"{dump_thread_stacks()}\n"
        f"===== metrics registry snapshot =====\n{snapshot}"
    )


class Watchdog:
    """Deadline thread around one named stage; use as a context manager.

        with Watchdog("first_compile", deadline_s=1800):
            build_kernels()

    On deadline expiry: dump (stacks + registry) -> interrupt the main thread
    -> raise CompileStallError from __exit__. With `hard_exit_grace_s > 0`, a
    main thread still wedged in native code that long after the dump gets
    `os._exit(EXIT_CODE_STALL)` — no hang survives."""

    def __init__(
        self,
        stage: str,
        deadline_s: float,
        hard_exit_grace_s: float = 0.0,
        error_factory: Optional[Callable[[str, float, Optional[str]], BaseException]] = None,
        exit_code: int = EXIT_CODE_STALL,
    ):
        self.stage = stage
        self.deadline_s = float(deadline_s)
        self.hard_exit_grace_s = float(hard_exit_grace_s)
        # The stall error raised on expiry, (stage, deadline_s, dump) ->
        # exception: CompileStallError by default, FleetBarrierTimeout for
        # the fleet's barriers.
        self._error_factory = error_factory or (
            lambda stage, deadline, dump: CompileStallError(stage, deadline, dump=dump))
        self._exit_code = int(exit_code)
        self._component = f"host-{stage}"
        self._timer: Optional[threading.Timer] = None
        self._hard_timer: Optional[threading.Timer] = None
        self._done = threading.Event()
        self.stalled = False
        self.dump: Optional[str] = None

    # -- watchdog-thread side -------------------------------------------------
    def _on_deadline(self) -> None:
        if self._done.is_set():
            return
        dump = dump_state(self.stage)
        # Re-check AFTER the (non-trivial) dump: if the protected section
        # completed while we were formatting stacks, interrupting now would
        # land a stray KeyboardInterrupt in whatever the host loop runs next
        # — a healthy run killed by its own watchdog. The remaining window
        # (between this check and interrupt delivery) is unavoidable; __exit__
        # converts any stalled-flagged exception, so only a post-__exit__
        # delivery could leak, and that requires the section to finish in
        # exactly these few instructions.
        if self._done.is_set():
            return
        self.stalled = True
        self.dump = dump
        log = get_logger("stoix_tpu_torch.resilience")
        log.error(
            "[watchdog] stage '%s' exceeded its %.0fs deadline — dumping all "
            "thread stacks and interrupting the main thread\n%s",
            self.stage, self.deadline_s, self.dump,
        )
        get_registry().counter(
            "stoix_tpu_watchdog_stalls_total",
            "Watchdog deadlines blown, by stage",
        ).inc(labels={"stage": self.stage})
        flightrec.get_flight_recorder().record(
            "watchdog_stall", stage=self.stage, deadline_s=self.deadline_s
        )
        if self.hard_exit_grace_s > 0:
            self._hard_timer = threading.Timer(self.hard_exit_grace_s, self._hard_exit)
            self._hard_timer.daemon = True
            self._hard_timer.start()
        import _thread

        _thread.interrupt_main()

    def _hard_exit(self) -> None:
        if self._done.is_set():
            return
        get_logger("stoix_tpu_torch.resilience").error(
            "[watchdog] main thread still wedged %.0fs after the '%s' stall "
            "dump (native call uninterruptible) — hard exit %d",
            self.hard_exit_grace_s, self.stage, self._exit_code,
        )
        # The rc-86 flight record: dumped from the watchdog thread because
        # os._exit skips atexit/finally — this is the last Python that runs.
        flightrec.dump_flight_record(
            None,
            reason=f"watchdog stall in stage '{self.stage}'",
            exit_code=self._exit_code,
        )
        # Flush what we can: logging handlers buffer, and this process is done.
        sys.stderr.flush()
        os._exit(self._exit_code)

    # -- protected-section side ----------------------------------------------
    def __enter__(self) -> "Watchdog":
        get_watchdog_board().beat(self._component)
        self._started_at = time.monotonic()
        self._timer = threading.Timer(self.deadline_s, self._on_deadline)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._done.set()
        if self._timer is not None:
            self._timer.cancel()
        if self._hard_timer is not None:
            self._hard_timer.cancel()
        get_watchdog_board().beat(self._component)
        if self.stalled:
            # The KeyboardInterrupt interrupt_main() raised (when it landed —
            # the section may also have completed in the race window) is the
            # watchdog's own mechanism, not an operator ^C: convert it.
            raise self._error_factory(self.stage, self.deadline_s, self.dump) from exc
        return False
