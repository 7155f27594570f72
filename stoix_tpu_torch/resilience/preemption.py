"""Graceful stop on preemption (counterpart of
stoix_tpu/resilience/preemption.py).

Schedulers deliver SIGTERM shortly before they take a machine back.
`PreemptionHandler` turns SIGTERM and SIGINT into a request: the host loop
reads `stop_requested()` at each window boundary, writes an emergency
checkpoint of the state it just produced, and returns normally (exit code
0), so a run with `logger.checkpointing.load_model` resumes from it.

The handler body only writes plain attributes: Python runs handlers between
bytecodes of the main thread, and taking a lock the interrupted frame holds
would deadlock. The consumer logs and counts once it sees the flag. A second
signal restores the previous handler and re-delivers itself, so a stuck
drain can still be killed. Installing from another thread is a no-op with a
warning (signal handlers belong to the main thread), and `uninstall`
restores the previous handlers: one process may run many experiments.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Dict, Optional

from stoix_tpu_torch.observability import get_logger, get_registry

_HANDLED = (signal.SIGTERM, signal.SIGINT)


class PreemptionHandler:
    """Graceful-stop flag fed by SIGTERM/SIGINT. Use as a context manager or
    via install()/uninstall(); always uninstall so later code (pytest, a
    second experiment) sees the original handlers."""

    def __init__(self) -> None:
        self._flag = False
        self._signum: Optional[int] = None
        self._prev: Dict[int, object] = {}
        self._installed = False

    # -- signal side (async-signal-safe: attribute writes only) --------------
    def _on_signal(self, signum, frame) -> None:
        if self._flag:
            # Second signal: the operator really means it. Put the previous
            # handler back and re-deliver so default semantics (kill /
            # KeyboardInterrupt) apply immediately.
            prev = self._prev.get(signum)
            signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self._flag = True
        self._signum = signum

    # -- host-loop side ------------------------------------------------------
    def install(self) -> "PreemptionHandler":
        if threading.current_thread() is not threading.main_thread():
            get_logger("stoix_tpu_torch.resilience").warning(
                "[preemption] not the main thread — signal handlers not "
                "installed; graceful preemption disabled for this run"
            )
            return self
        for signum in _HANDLED:
            self._prev[signum] = signal.signal(signum, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for signum, prev in self._prev.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, TypeError):  # interpreter teardown / exotic prev
                continue
        self._prev.clear()
        self._installed = False

    def stop_requested(self) -> bool:
        return self._flag

    @property
    def signal_name(self) -> Optional[str]:
        if self._signum is None:
            return None
        return signal.Signals(self._signum).name

    def acknowledge(self, step: int) -> None:
        """Called by the host loop when it first observes the flag: emits the
        log line + counter the signal handler could not safely emit itself."""
        get_registry().counter(
            "stoix_tpu_resilience_preemptions_total",
            "Graceful stops triggered by SIGTERM/SIGINT",
        ).inc(labels={"signal": self.signal_name or "unknown"})
        get_logger("stoix_tpu_torch.resilience").warning(
            "[preemption] %s received — graceful stop requested at step %d: "
            "draining dispatcher, then emergency checkpoint",
            self.signal_name, step,
        )

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc_info) -> None:
        self.uninstall()
