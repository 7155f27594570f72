"""Deterministic fault injection (counterpart of
stoix_tpu/resilience/faultinject.py).

Armed through the `STOIX_TPU_FAULT` environment variable or the
`arch.fault_spec` config key, e.g. `STOIX_TPU_FAULT=nan_loss:2,sigterm:1`.
The spec is comma-separated `name[:arg]` entries (a mapping `{nan_loss: 2}`
is taken too, as YAML parses `key:value`); the environment variable wins
over the config. The faults, each with the hook that fires it:

  actor_crash:N   (Sebulba) actor 0 raises InjectedFault at the top of
                  rollout N (one-shot: a supervised replacement does not
                  crash again)
  queue_stall:N   (Sebulba) actor 0 wedges (sleeps, still alive) at the top
                  of rollout N until the run stops or `max_stall_s` passes
  nan_loss:N      (Anakin) the update guard (resilience/guards.py) poisons
                  the loss and every float leaf of the update with NaN at
                  optimizer step count N (`poison_step`)
  ckpt_corrupt    (Anakin) the next `Checkpointer.save` overwrites the saved
                  step's files with garbage (one-shot): the restore's
                  fallback walk runs past it
  sigterm:N       (Anakin) the host loop sends SIGTERM to its own process
                  after window N (one-shot): the preemption path end to end
  backend_wedge   (Anakin) the preflight probe's child sleeps before it
                  touches CUDA (resilience/preflight.py), so every attempt
                  times out and BackendUnavailableError comes within its
                  deadline
  slow_compile:S  (Anakin) the host loop sleeps S seconds inside the
                  watchdog-guarded first-compile stage (one-shot)
  host_stall:S    (Anakin) this process sleeps S seconds at the top of
                  window 1 (one-shot): a straggler, alive but slow
  bitflip:N       (Anakin) one mantissa bit of rank 0's params is flipped
                  going into window N (one-shot): finite, silent, the class
                  only the integrity sentinel's fingerprints see
  host_loss:N     (Anakin) this process freezes (SIGSTOP to itself: every
                  thread, the fleet's heartbeat publisher included, halts and
                  its sockets stay open) right after window N's learn step:
                  the silent loss only the fleet's heartbeats catch. Armed on
                  one rank, the survivors' monitor declares the partition,
                  saves the emergency store and exits 87 (resilience/fleet.py).
                  A SIGCONT makes it exit EXIT_CODE_FAILURE: the host stays
                  lost. A frozen process ignores SIGTERM: end it with SIGKILL.
  barrier_wedge   fleet.guarded_barrier sleeps instead of arriving at its
                  barrier (one-shot): the barrier watchdog's
                  FleetBarrierTimeout without a dead peer
  shrink:N        (Anakin) after window N the run vacates for half its
                  devices (one-shot): emergency snapshot, `resize_request.json`,
                  flight record, exit 89 (resilience/elastic.py)
  grow:N          (Anakin) the same with twice its devices

`check_anakin_plan` and `check_sebulba_plan` refuse, naming it, every armed
fault their runners do not inject: the serving faults (swap_poison,
replica_kill, replica_slow, feedback_stall) wait for ROADMAP A18. `FaultPlan`
refuses a name the JAX package does not know. Each fault that fires adds one
to `stoix_tpu_resilience_faults_injected_total` (labelled by fault). Every
hook is a no-op (one None check) when no plan is armed; `configure` is
called once a run, so one-shot state never leaks from one run into the next.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from stoix_tpu_torch.observability import flightrec, get_registry, goodput
from stoix_tpu_torch.resilience.errors import InjectedFault
from stoix_tpu_torch.resilience.exit_codes import EXIT_CODE_FAILURE

ENV_VAR = "STOIX_TPU_FAULT"
FAULTS_INJECTED = "stoix_tpu_resilience_faults_injected_total"

# Every fault the JAX package knows; FaultPlan refuses any other name.
_KNOWN = (
    "actor_crash", "queue_stall", "nan_loss", "ckpt_corrupt", "sigterm", "backend_wedge",
    "slow_compile", "host_loss", "host_stall", "barrier_wedge", "bitflip", "swap_poison",
    "shrink", "grow", "replica_kill", "replica_slow", "feedback_stall",
)
# The faults the port's Sebulba runners inject, and the Anakin runner's.
SEBULBA_FAULTS = ("actor_crash", "queue_stall")
ANAKIN_FAULTS = ("nan_loss", "ckpt_corrupt", "sigterm", "backend_wedge", "slow_compile",
                 "host_stall", "bitflip", "host_loss", "barrier_wedge", "shrink", "grow")
# Where each fault no runner of the port injects is waiting.
_WAITING = {name: "serving, ROADMAP A18"
            for name in ("swap_poison", "replica_kill", "replica_slow", "feedback_stall")}
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


def _refuse_others(plan: Optional[FaultPlan], taken: Tuple[str, ...], runner: str) -> None:
    if plan is None:
        return
    other = sorted(name for name in plan.faults if name not in taken)
    if other:
        named = ", ".join(f"{name} ({_WAITING.get(name, 'not injected by this runner')})"
                          for name in other)
        raise NotImplementedError(
            f"not ported: arch.fault_spec / {ENV_VAR} fault(s) {named} (the {runner} "
            f"inject{'s' if runner.endswith('runner') else ''} {', '.join(taken)})")


def check_sebulba_plan(plan: Optional[FaultPlan]) -> None:
    """NotImplementedError naming every armed fault a Sebulba runner of the
    port does not inject."""
    _refuse_others(plan, SEBULBA_FAULTS, "Sebulba runners")


def check_anakin_plan(plan: Optional[FaultPlan]) -> None:
    """NotImplementedError naming every armed fault the Anakin runner of the
    port does not inject."""
    _refuse_others(plan, ANAKIN_FAULTS, "Anakin runner")


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
    flightrec.get_flight_recorder().record("fault", fault="queue_stall", actor=actor_id,
                                           rollout=rollout_idx)
    wedge_started = time.monotonic()
    deadline = wedge_started + max_stall_s
    try:
        while time.monotonic() < deadline:
            if should_abort is not None and should_abort():
                return
            time.sleep(0.05)
    finally:
        # The seconds spent wedged are stall, however the wedge ends.
        goodput.note_stall(time.monotonic() - wedge_started)


def poison_step() -> Optional[int]:
    """The optimizer step count at which the update guard poisons the loss
    and the update (`nan_loss:N`), or None."""
    plan = get_plan()
    return None if plan is None else plan.arg("nan_loss")


def maybe_sigterm(window_idx: int) -> None:
    """Send SIGTERM to this process after window N (`sigterm:N`, one-shot)."""
    plan = get_plan()
    if plan is None:
        return
    at = plan.arg("sigterm")
    if at is not None and window_idx == at and plan.consume("sigterm"):
        _injected_counter().inc(labels={"fault": "sigterm"})
        os.kill(os.getpid(), signal.SIGTERM)


def maybe_slow_compile() -> None:
    """Sleep `slow_compile:S` seconds inside the watchdog-guarded compile
    stage (one-shot). The sleep is sliced: the watchdog's interrupt lands
    between bytecodes, so it stops the stall within a slice."""
    plan = get_plan()
    if plan is None:
        return
    secs = plan.arg("slow_compile")
    if secs is None or not plan.consume("slow_compile"):
        return
    _injected_counter().inc(labels={"fault": "slow_compile"})
    _LOG.warning("[faultinject] injecting %ds compile delay", secs)
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        time.sleep(0.05)


def maybe_host_stall(window_idx: int) -> None:
    """Sleep `host_stall:S` seconds at the top of window 1 (one-shot), the
    seconds charged to the run's goodput ledger as stall."""
    plan = get_plan()
    if plan is None:
        return
    secs = plan.arg("host_stall")
    if secs is None or window_idx != 1 or not plan.consume("host_stall"):
        return
    _injected_counter().inc(labels={"fault": "host_stall"})
    _LOG.warning("[faultinject] host stalling %ds at window %d", secs, window_idx)
    flightrec.get_flight_recorder().record("fault", fault="host_stall", window=window_idx,
                                           seconds=float(secs))
    time.sleep(secs)
    goodput.note_stall(float(secs))


def maybe_host_loss(window_idx: int) -> None:
    """Freeze this process (SIGSTOP to itself) after window N's learn step
    when `host_loss:N` is armed (one-shot). A freeze, not an exit: a process
    that closes its sockets fails its peers' collectives at once, and the
    loss that needs the fleet layer is the silent one, where every
    collective just stops answering."""
    plan = get_plan()
    if plan is None:
        return
    at = plan.arg("host_loss")
    if at is not None and window_idx == at and plan.consume("host_loss"):
        _injected_counter().inc(labels={"fault": "host_loss"})
        _LOG.warning("[faultinject] host_loss at window %d — freezing (SIGSTOP) NOW", window_idx)
        import sys

        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGSTOP)
        # Only reached if something SIGCONTs the frozen process: the host is
        # still lost.
        os._exit(EXIT_CODE_FAILURE)


def maybe_resize(window_idx: int) -> Optional[str]:
    """"shrink" or "grow" when a `shrink:N` or `grow:N` fault fires after
    window N (one-shot each), else None. The hook only decides: the runner
    owns the exit protocol (resilience/elastic.py::resize_exit), as only it
    holds the fleet coordinator and the step."""
    plan = get_plan()
    if plan is None:
        return None
    for action in ("shrink", "grow"):
        at = plan.arg(action)
        if at is not None and window_idx == at and plan.consume(action):
            _injected_counter().inc(labels={"fault": action})
            _LOG.warning("[faultinject] %s resize requested at window %d", action, window_idx)
            flightrec.get_flight_recorder().record("fault", fault=action, window=window_idx)
            return action
    return None


def maybe_barrier_wedge(barrier: str, max_wedge_s: float = 3600.0) -> None:
    """Wedge (sleep, never arrive) instead of entering a fleet barrier when
    `barrier_wedge` is armed (one-shot). The sleep is sliced: the barrier
    watchdog's interrupt lands between bytecodes."""
    plan = get_plan()
    if plan is None:
        return
    if plan.arg("barrier_wedge") is None or not plan.consume("barrier_wedge"):
        return
    _injected_counter().inc(labels={"fault": "barrier_wedge"})
    _LOG.warning("[faultinject] wedging instead of arriving at barrier %r", barrier)
    deadline = time.monotonic() + max_wedge_s
    while time.monotonic() < deadline:
        time.sleep(0.05)


# Top mantissa bit of each float dtype, with the integer view that flips it:
# the flip perturbs the value by about half, so the next `params + update`
# cannot round it away.
_TOP_MANTISSA_BIT = {torch.float16: (torch.int16, 9), torch.bfloat16: (torch.int16, 6),
                     torch.float32: (torch.int32, 22), torch.float64: (torch.int64, 51)}


def flip_top_mantissa_bit(leaf: torch.Tensor) -> torch.Tensor:
    """A copy of a float tensor with the top mantissa bit of its
    largest-magnitude element flipped (finite: the exponent is untouched)."""
    view_dtype, shift = _TOP_MANTISSA_BIT[leaf.dtype]
    flipped = leaf.detach().clone().reshape(-1)
    if flipped.numel():
        element = int(torch.argmax(flipped.abs().to(torch.float64)))
        bits = flipped.view(view_dtype)
        bits[element] = bits[element] ^ (1 << shift)
    return flipped.reshape(leaf.shape)


def _paths(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if hasattr(tree, "_fields"):
        children = [(name, getattr(tree, name)) for name in tree._fields]
    elif isinstance(tree, dict):
        children = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        children = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return []
    return [entry for name, child in children for entry in _paths(child, prefix + (name,))]


def _replace(tree: Any, path: Tuple[str, ...], value: torch.Tensor) -> Any:
    if not path:
        return value
    head, rest = path[0], path[1:]
    if hasattr(tree, "_fields"):
        return tree._replace(**{head: _replace(getattr(tree, head), rest, value)})
    if isinstance(tree, dict):
        key = next(k for k in tree if str(k) == head)
        return {**tree, key: _replace(tree[key], rest, value)}
    items = list(tree)
    items[int(head)] = _replace(items[int(head)], rest, value)
    return type(tree)(items)


def maybe_bitflip(state: Any, window_idx: int) -> Any:
    """With `bitflip:N` armed (one-shot), the state going into window N with
    one mantissa bit of rank 0's params flipped: the largest float tensor of
    the top-level `params` (else of any path naming 'param', else any). Other
    ranks keep theirs, so their replicas disagree. Returns the state (the
    same object when nothing fires)."""
    plan = get_plan()
    if plan is None:
        return state
    at = plan.arg("bitflip")
    if at is None or window_idx != at or not plan.consume("bitflip"):
        return state
    from stoix_tpu_torch.parallel.distributed import is_coordinator

    flat = [(path, leaf) for path, leaf in _paths(state) if leaf.dtype in _TOP_MANTISSA_BIT]

    def ranked(predicate):
        return [(leaf.numel(), i) for i, (path, leaf) in enumerate(flat)
                if predicate("/".join(path).lower())]

    candidates = (ranked(lambda key: key.startswith("params/")) or
                  ranked(lambda key: "param" in key) or ranked(lambda key: True))
    if not candidates:
        _LOG.warning("[faultinject] bitflip armed but the state has no float tensor — skipping")
        return state
    path, leaf = flat[max(candidates)[1]]
    _injected_counter().inc(labels={"fault": "bitflip"})
    if not is_coordinator():
        return state
    _LOG.warning("[faultinject] flipping one mantissa bit of %s on rank 0 going into window %d",
                 "/".join(path), window_idx)
    return _replace(state, path, flip_top_mantissa_bit(leaf))


def backend_wedge_armed() -> bool:
    """Whether the probe child's wedge is armed (it fires in the child)."""
    plan = get_plan()
    return plan is not None and plan.arg("backend_wedge") is not None


def consume_ckpt_corrupt() -> bool:
    plan = get_plan()
    return plan is not None and plan.consume("ckpt_corrupt")


def corrupt_checkpoint_files(step_dir: str) -> int:
    """Overwrite every state file under `step_dir` with garbage (truncation
    and a bad magic), leaving `metrics.json`, so the store still opens and
    the restore must walk past the step. Returns how many files it mangled."""
    mangled = 0
    for name in sorted(os.listdir(step_dir)):
        if not (name.startswith("state") and name.endswith(".pt")):
            continue
        try:
            with open(os.path.join(step_dir, name), "wb") as f:
                f.write(b"\x00CORRUPTED-BY-FAULT-INJECTION\x00")
            mangled += 1
        except OSError:  # chaos must not crash the host loop
            pass
    if mangled:
        _injected_counter().inc(labels={"fault": "ckpt_corrupt"})
        _LOG.warning("[faultinject] corrupted %d file(s) under %s", mangled, step_dir)
    return mangled
