"""Deterministic fault injection for Sebulba (counterpart of the Sebulba half
of stoix_tpu/resilience/faultinject.py).

Armed through the `STOIX_TPU_FAULT` environment variable or the
`arch.fault_spec` config key, e.g. `STOIX_TPU_FAULT=actor_crash:2`. The
spec is comma-separated `name[:arg]` entries (a mapping `{actor_crash: 2}`
is taken too, as YAML parses `key:value`); the environment variable wins
over the config. The faults the Sebulba runners take:

  actor_crash:N   actor 0 raises InjectedFault at the top of rollout N
                  (one-shot: a supervised replacement does not crash again)
  queue_stall:N   actor 0 wedges (sleeps, still alive) at the top of rollout
                  N, until the run stops or `max_stall_s` passes (no flight
                  record or goodput stall is noted: those layers wait for
                  ROADMAP A19)

Every other fault of the JAX package (`nan_loss`, `sigterm`, `bitflip`, ...)
belongs to layers the port does not have yet: `check_sebulba_plan` refuses
it, naming it, and `FaultPlan` refuses a name the JAX package does not know.
Each fault that fires adds one to `stoix_tpu_resilience_faults_injected_total`
(labelled by fault). Every injection point is a no-op (one None check) when
no plan is armed; `configure` is called once a run, so one-shot state never
leaks from one run into the next.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from stoix_tpu_torch.observability import get_registry
from stoix_tpu_torch.resilience.errors import InjectedFault

ENV_VAR = "STOIX_TPU_FAULT"
FAULTS_INJECTED = "stoix_tpu_resilience_faults_injected_total"

# Every fault the JAX package knows; FaultPlan refuses any other name.
_KNOWN = (
    "actor_crash", "queue_stall", "nan_loss", "ckpt_corrupt", "sigterm", "backend_wedge",
    "slow_compile", "host_loss", "host_stall", "barrier_wedge", "bitflip", "swap_poison",
    "shrink", "grow", "replica_kill", "replica_slow", "feedback_stall",
)
# The faults the port's Sebulba runners inject.
SEBULBA_FAULTS = ("actor_crash", "queue_stall")
_LOG = logging.getLogger("stoix_tpu_torch.resilience")


class FaultPlan:
    """A parsed fault spec and its one-shot consumption state (thread-safe)."""

    def __init__(self, faults: Dict[str, Optional[int]]):
        unknown = set(faults) - set(_KNOWN)
        if unknown:
            raise ValueError(f"unknown fault(s) {sorted(unknown)}; known: {list(_KNOWN)}")
        self.faults = dict(faults)
        self._lock = threading.Lock()
        self._consumed: set = set()

    def arg(self, name: str) -> Optional[int]:
        """The fault's trigger argument (0 for a fault armed without one), or
        None when it is not armed."""
        if name not in self.faults:
            return None
        value = self.faults[name]
        return 0 if value is None else int(value)

    def consume(self, name: str) -> bool:
        """One-shot gate: True exactly once per armed fault per plan."""
        with self._lock:
            if name not in self.faults or name in self._consumed:
                return False
            self._consumed.add(name)
            return True

    def __repr__(self) -> str:
        return f"FaultPlan({self.faults})"


def parse_spec(spec: Any) -> Optional[FaultPlan]:
    """A spec string (`name:arg,name`) or mapping as a FaultPlan; None for
    no faults."""
    if not spec:
        return None
    if isinstance(spec, dict) or hasattr(spec, "items"):
        return FaultPlan({str(k): (None if v is None else int(v)) for k, v in spec.items()})
    faults: Dict[str, Optional[int]] = {}
    for entry in str(spec).split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, arg = entry.partition(":")
        faults[name.strip()] = int(arg) if arg else None
    return FaultPlan(faults) if faults else None


_lock = threading.Lock()
_plan: Optional[FaultPlan] = None


def configure(config_spec: Any = None) -> Optional[FaultPlan]:
    """Install the process-wide plan for one run: `STOIX_TPU_FAULT` when set,
    else `config_spec`. Resets the one-shot state; call at the run's start."""
    global _plan
    spec = os.environ.get(ENV_VAR) or config_spec
    with _lock:
        _plan = parse_spec(spec)
        if _plan is not None:
            _LOG.warning("[faultinject] CHAOS ACTIVE: %s", _plan)
    return _plan


def get_plan() -> Optional[FaultPlan]:
    with _lock:
        return _plan


def reset() -> None:
    global _plan
    with _lock:
        _plan = None


def check_sebulba_plan(plan: Optional[FaultPlan]) -> None:
    """NotImplementedError naming every armed fault a Sebulba runner of the
    port does not inject."""
    if plan is None:
        return
    other = [name for name in plan.faults if name not in SEBULBA_FAULTS]
    if other:
        raise NotImplementedError(
            f"not ported: arch.fault_spec / {ENV_VAR} fault(s) {', '.join(sorted(other))} "
            f"(the Sebulba runners inject {', '.join(SEBULBA_FAULTS)})")


def _injected_counter():
    return get_registry().counter(FAULTS_INJECTED,
                                  "Faults fired by the injection harness, by fault name")


def maybe_crash_actor(actor_id: int, rollout_idx: int) -> None:
    """Raise InjectedFault when `actor_crash:N` is armed, at actor 0's
    rollout N. One-shot: the supervised replacement does not crash again."""
    plan = get_plan()
    if plan is None or actor_id != 0:
        return
    at = plan.arg("actor_crash")
    if at is not None and rollout_idx == at and plan.consume("actor_crash"):
        _injected_counter().inc(labels={"fault": "actor_crash"})
        raise InjectedFault(f"injected actor crash (actor-{actor_id}, rollout {rollout_idx})")


def maybe_stall_queue(actor_id: int, rollout_idx: int,
                      should_abort: Optional[Callable[[], bool]] = None,
                      max_stall_s: float = 600.0) -> None:
    """Wedge (sleep, the thread alive) when `queue_stall:N` is armed, at
    actor 0's rollout N, until `should_abort()` turns true or `max_stall_s`
    passes: the silent stall that heartbeat wedge detection exists for."""
    plan = get_plan()
    if plan is None or actor_id != 0:
        return
    at = plan.arg("queue_stall")
    if at is None or rollout_idx != at or not plan.consume("queue_stall"):
        return
    _injected_counter().inc(labels={"fault": "queue_stall"})
    _LOG.warning("[faultinject] actor-%d wedged at rollout %d", actor_id, rollout_idx)
    deadline = time.monotonic() + max_stall_s
    while time.monotonic() < deadline:
        if should_abort is not None and should_abort():
            return
        time.sleep(0.05)
