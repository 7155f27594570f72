"""Sebulba host-side plumbing (counterpart of stoix_tpu/sebulba/core.py):
threads and bounded queues between the actor devices and the learner
devices.

  - ThreadLifetime: the cooperative stop signal;
  - OnPolicyPipeline: one queue.Queue(maxsize=1) per actor; the learner
    collects from ALL actors each update (backpressure by construction);
  - OffPolicyPipeline: one bounded queue of (actor_id, payload) pairs that
    every actor pushes to; the learner polls whatever has arrived and never
    waits on a particular actor (Sebulba ff_dqn and IMPACT);
  - ParameterServer: pushes each new version of the learner's params to
    every actor queue, placed ONCE per device (`.to(device)`); `None` is the
    shutdown sentinel, and `reprime` re-feeds a restarted actor;
  - AsyncEvaluator: evaluations off the learner's critical path.

Every queue hand-off records depth and put/get waits
(`stoix_tpu_sebulba_queue_*`), every component beats a HeartbeatBoard, and
a collect timeout raises ActorStarvationError naming the starved actor.
Both queue layers carry typed ComponentFailure poison-pills: the supervisor
injects one for an unrecoverable actor, and the peer raises it on its next
get instead of burning its timeout. Every blocking call takes a timeout
(collect 180 s, a rollout's put 60 s, as in the JAX package). With `fleet`
(a resilience.fleet.FleetCoordinator) a collect fails at once with the typed
FleetPartitionError once the fleet's monitor has declared a partition,
instead of burning its timeout against actors that are healthy while a peer
process is gone.

Parameters on one card: `.to(device)` of a tensor already on that device is
the tensor itself, so actors read the learner's own tensors. That is safe
because nothing writes a parameter in place: the learner steps build new
tensors (utils/training.py's ClipAdam and `apply_updates`, the guard's
`torch.where`). A placed version therefore stays as it was handed out
(`tests/test_torch_sebulba_core.py`). Every thread launches on the device's
default stream, so work is ordered by issue: no side stream is used.

"""

from __future__ import annotations

import logging
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from stoix_tpu_torch.observability import (
    ActorStarvationError,
    HeartbeatBoard,
    StallDetector,
    get_registry,
    span,
)
from stoix_tpu_torch.resilience.errors import ComponentFailure, EvaluatorStallError
from stoix_tpu_torch.utils.tree import tree_map

COLLECT_TIMEOUT_S = 180.0
PUT_TIMEOUT_S = 60.0
EVALUATOR_ERRORS = "stoix_tpu_sebulba_evaluator_errors_total"


def _replace_nowait(q: "queue.Queue", item: Any) -> None:
    """Freshest-wins replacement on a maxsize-1 queue: drop a stale entry if
    present, then put without blocking (a concurrent producer winning the
    slot is fine: its item is at least as fresh)."""
    try:
        q.get_nowait()
    except queue.Empty:
        pass
    try:
        q.put_nowait(item)
    except queue.Full:
        pass


def _queue_instruments():
    registry = get_registry()
    return (
        registry.gauge("stoix_tpu_sebulba_queue_depth",
                       "Items currently buffered per Sebulba queue"),
        registry.histogram("stoix_tpu_sebulba_queue_put_wait_seconds",
                           "Producer-side blocking time per queue put"),
        registry.histogram("stoix_tpu_sebulba_queue_get_wait_seconds",
                           "Consumer-side blocking time per queue get"),
    )


class ThreadLifetime:
    def __init__(self) -> None:
        self._stop = threading.Event()

    def should_stop(self) -> bool:
        return self._stop.is_set()

    def stop(self) -> None:
        self._stop.set()


class OnPolicyPipeline:
    """Bounded rollout queues, one per actor thread; `fleet` makes a collect
    fail fast on a declared partition."""

    def __init__(self, num_actors: int, max_size: int = 1, fleet: Optional[Any] = None):
        self._queues: List[queue.Queue] = [queue.Queue(maxsize=max_size)
                                           for _ in range(num_actors)]
        self.heartbeats = HeartbeatBoard()
        self._depth, self._put_wait, self._get_wait = _queue_instruments()
        self._failures: Dict[int, ComponentFailure] = {}
        self._failure_lock = threading.Lock()
        self._fleet = fleet

    def fail(self, actor_id: int, failure: ComponentFailure) -> None:
        """Poison-pill injection (the supervisor's path): record the failure
        and wake a learner blocked on this actor's queue. A buffered payload
        may be dropped to make room: on the failure path the batch is lost
        anyway."""
        with self._failure_lock:
            self._failures[actor_id] = failure
        # collect_rollouts consults _failures before blocking, so a lost put
        # is not a lost failure.
        _replace_nowait(self._queues[actor_id], failure)

    def send_rollout(self, actor_id: int, payload: Any,
                     timeout: Optional[float] = PUT_TIMEOUT_S) -> None:
        labels = {"queue": "rollout", "actor": str(actor_id)}
        start = time.perf_counter()
        try:
            with span("pipeline_put", actor=actor_id):
                self._queues[actor_id].put(payload, timeout=timeout)
        finally:
            # A queue.Full timeout is the worst backpressure sample there is.
            self._put_wait.observe(time.perf_counter() - start, labels)
            self._depth.set(self._queues[actor_id].qsize(), labels)
        self.heartbeats.beat(f"actor-{actor_id}")

    def collect_rollouts(self, timeout: float = COLLECT_TIMEOUT_S) -> List[Any]:
        """Blocks until every actor has contributed one rollout. A timeout
        names the starved actor and its last heartbeat's age."""
        detector = StallDetector(self.heartbeats, stale_after_s=max(1.0, timeout / 4))
        payloads = []
        for actor_id, q in enumerate(self._queues):
            if self._fleet is not None:
                self._fleet.check_partition()
            with self._failure_lock:
                failure = self._failures.get(actor_id)
            if failure is not None:
                raise failure
            labels = {"queue": "rollout", "actor": str(actor_id)}
            start = time.perf_counter()
            try:
                with span("pipeline_get", actor=actor_id):
                    payload = q.get(timeout=timeout)
                    if isinstance(payload, ComponentFailure):
                        raise payload
                    payloads.append(payload)
            except queue.Empty:
                raise ActorStarvationError(
                    actor_id, timeout, detector.diagnose(waiting_on=f"actor-{actor_id}"),
                    self.heartbeats.age(f"actor-{actor_id}"),
                ) from None
            self._get_wait.observe(time.perf_counter() - start, labels)
            self._depth.set(q.qsize(), labels)
        self.heartbeats.beat("learner")
        return payloads

    def drain(self, timeout: float = 0.5) -> int:
        """Shutdown's drain: unblock producers stuck in put(), recording no
        wait, depth or heartbeat. Returns the items drained; stops at the
        first empty queue."""
        drained = 0
        for q in self._queues:
            try:
                q.get(timeout=timeout)
                drained += 1
            except queue.Empty:
                break
        return drained


class OffPolicyPipeline:
    """Off-policy ingestion: actors PUSH payloads whenever a rollout chunk is
    ready; the learner POLLS whatever has arrived and samples its replay
    (or re-steps a buffered batch) independently, so one slow or restarting
    actor never stalls it.

    One bounded queue carries (actor_id, payload) pairs from every actor: a
    full queue back-pressures the producers (their put blocks), an empty
    one never blocks the learner past the timeout it chose. The supervisor
    injects a typed ComponentFailure poison-pill for an unrecoverable actor,
    and the learner raises it on its next poll."""

    def __init__(self, num_actors: int, depth_per_actor: int = 2, fleet: Optional[Any] = None):
        self.num_actors = num_actors
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, num_actors * depth_per_actor))
        self.heartbeats = HeartbeatBoard()
        self._depth, self._put_wait, self._get_wait = _queue_instruments()
        self._failures: Dict[int, ComponentFailure] = {}
        self._failure_lock = threading.Lock()
        self._fleet = fleet

    def _check_failures(self) -> None:
        if self._fleet is not None:
            self._fleet.check_partition()
        with self._failure_lock:
            for failure in self._failures.values():
                raise failure

    def fail(self, actor_id: int, failure: ComponentFailure) -> None:
        """Poison-pill injection (the supervisor's path): record the failure
        and wake a learner blocked in wait_for_data. A full queue drops one
        healthy payload to make room (the learner consults the failures
        before blocking, so a lost put is never a lost failure)."""
        with self._failure_lock:
            self._failures[actor_id] = failure
        try:
            self._queue.put_nowait(failure)
        except queue.Full:
            try:
                self._queue.get_nowait()
                self._queue.put_nowait(failure)
            except (queue.Empty, queue.Full):
                pass

    def push(self, actor_id: int, payload: Any, timeout: Optional[float] = None) -> None:
        labels = {"queue": "transitions", "actor": str(actor_id)}
        start = time.perf_counter()
        try:
            with span("offpolicy_push", actor=actor_id):
                self._queue.put((actor_id, payload), timeout=timeout)
        finally:
            # A queue.Full timeout is the worst backpressure sample there is.
            self._put_wait.observe(time.perf_counter() - start, labels)
            self._depth.set(self._queue.qsize(), labels)
        self.heartbeats.beat(f"actor-{actor_id}")

    def poll(self, max_items: int = 64, timeout: float = 0.0) -> List[Any]:
        """Up to `max_items` pending (actor_id, payload) pairs. Only the
        first get may block (up to `timeout`); the rest do not. Raises the
        typed ComponentFailure of an actor that is gone for good."""
        self._check_failures()
        labels = {"queue": "transitions", "actor": "learner"}
        items: List[Any] = []
        start = time.perf_counter()
        with span("offpolicy_poll"):
            while len(items) < max_items:
                try:
                    got = self._queue.get(timeout=timeout if not items else 0.0)
                except queue.Empty:
                    break
                if isinstance(got, ComponentFailure):
                    raise got
                items.append(got)
        if items:
            self._get_wait.observe(time.perf_counter() - start, labels)
            self._depth.set(self._queue.qsize(), labels)
            self.heartbeats.beat("learner")
        return items

    def wait_for_data(self, timeout: float = COLLECT_TIMEOUT_S) -> List[Any]:
        """Block until at least one payload arrives. A timeout raises
        ActorStarvationError naming the stalest actor (one that never beat
        first, else the oldest heartbeat) and its heartbeat's age."""
        detector = StallDetector(self.heartbeats, stale_after_s=max(1.0, timeout / 4))
        items = self.poll(timeout=timeout)
        if not items:
            stalest, stalest_age = 0, -1.0
            for actor_id in range(self.num_actors):
                actor_age = self.heartbeats.age(f"actor-{actor_id}")
                if actor_age is None:
                    stalest, stalest_age = actor_id, None
                    break
                if stalest_age is not None and actor_age > stalest_age:
                    stalest, stalest_age = actor_id, actor_age
            raise ActorStarvationError(stalest, timeout,
                                       detector.diagnose(waiting_on=f"actor-{stalest}"),
                                       stalest_age)
        return items

    def drain(self, timeout: float = 0.5) -> int:
        """Shutdown's drain: unblock producers stuck in put(), recording no
        wait, depth or heartbeat. Returns the items drained."""
        drained = 0
        while True:
            try:
                self._queue.get(timeout=timeout)
                drained += 1
            except queue.Empty:
                return drained


class VersionedParams(NamedTuple):
    """A parameter queue's entry: the placed params and the monotone version
    (distribute_params call count) they came from."""

    version: int
    params: Any


def place(params: Any, device: torch.device) -> Any:
    """`params` on `device`: every tensor leaf `.to(device)`, which is the
    tensor itself where it already lies there."""
    return tree_map(lambda x: x.to(device), params)


class ParameterServer:
    """The latest params for the actor devices, placed ONCE PER DEVICE per
    version: actors sharing a device receive the same placed copy through
    their own queues, and `reprime` reuses it. Every distribute_params bumps
    a monotone version; entries are VersionedParams, `get_params` strips the
    version."""

    def __init__(self, actor_devices: List[Any], actors_per_device: int,
                 heartbeats: Optional[HeartbeatBoard] = None):
        self._devices = [d for d in actor_devices for _ in range(actors_per_device)]
        self._queues: List[queue.Queue] = [queue.Queue(maxsize=1) for _ in self._devices]
        self._version = 0  # bumped once per distribute_params (learner thread)
        self._latest: Any = None  # the last distributed params, for reprime()
        # (params, {device: placed copy}, version) of the last COMPLETED push,
        # so reprime can tell whether the placed copies are self._latest's.
        self._placed_entry: Optional[tuple] = None
        self.heartbeats = heartbeats if heartbeats is not None else HeartbeatBoard()
        self._depth, self._put_wait, self._get_wait = _queue_instruments()
        registry = get_registry()
        self._pushes = registry.counter("stoix_tpu_sebulba_param_pushes_total",
                                        "Parameter versions pushed to each actor queue")
        self._transfer = registry.histogram(
            "stoix_tpu_sebulba_param_transfer_seconds",
            "Host-side placement time per param placement (once per DEVICE per version, "
            "not per actor; NOT queue blocking)")

    @property
    def version(self) -> int:
        """The count of distribute_params calls: the learner's current policy
        version (0 before the first push)."""
        return self._version

    def _place(self, params: Any, device: Any, placed: Dict[Any, Any]) -> Any:
        """Placed once per device; later actors on the device reuse it."""
        local = placed.get(device)
        if local is None:
            start = time.perf_counter()
            local = place(params, device)
            self._transfer.observe(time.perf_counter() - start,
                                   {"queue": "params", "device": str(device)})
            placed[device] = local
        return local

    def distribute_params(self, params: Any) -> None:
        self._version += 1
        version = self._version
        self._latest = params
        placed: Dict[Any, Any] = {}
        with span("param_push", actors=len(self._queues)):
            for actor_id, (device, q) in enumerate(zip(self._devices, self._queues)):
                labels = {"queue": "params", "actor": str(actor_id)}
                local = self._place(params, device, placed)
                start = time.perf_counter()
                # Keep only the freshest params: drop a stale entry if present.
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                q.put(VersionedParams(version, local), timeout=PUT_TIMEOUT_S)
                self._put_wait.observe(time.perf_counter() - start, labels)
                self._depth.set(q.qsize(), labels)
                self._pushes.inc(labels={"actor": str(actor_id)})
        self._placed_entry = (params, placed, version)
        self.heartbeats.beat("param-server")

    def reprime(self, actor_id: int) -> bool:
        """Re-feed the LATEST params to one actor queue (the supervisor calls
        this before starting a replacement actor). Never blocks; reuses the
        last completed version's placed copy for the actor's device."""
        latest = self._latest
        if latest is None:
            return False
        entry = self._placed_entry
        if entry is not None and entry[0] is latest:
            placed, version = entry[1], entry[2]
        else:
            # Mid-push: its dict may hold older copies; place afresh.
            placed, version = {}, self._version
        local = self._place(latest, self._devices[actor_id], placed)
        _replace_nowait(self._queues[actor_id], VersionedParams(version, local))
        return True

    def fail(self, failure: ComponentFailure, actor_id: int) -> None:
        """Poison one actor's param queue: an actor blocked in get_params
        raises `failure` instead of waiting on params that will never come."""
        _replace_nowait(self._queues[actor_id], failure)

    def get_params(self, actor_id: int, timeout: Optional[float] = None) -> Any:
        """Fresh params, or None (the shutdown sentinel); raises a
        ComponentFailure poison-pill, or queue.Empty after `timeout`."""
        got = self.get_params_versioned(actor_id, timeout=timeout)
        return None if got is None else got.params

    def get_params_versioned(self, actor_id: int,
                             timeout: Optional[float] = None) -> Optional[VersionedParams]:
        labels = {"queue": "params", "actor": str(actor_id)}
        start = time.perf_counter()
        with span("param_get", actor=actor_id):
            entry = self._queues[actor_id].get(timeout=timeout)
        self._get_wait.observe(time.perf_counter() - start, labels)
        self._depth.set(self._queues[actor_id].qsize(), labels)
        if isinstance(entry, ComponentFailure):
            raise entry
        return entry

    def shutdown(self) -> None:
        for q in self._queues:
            _replace_nowait(q, None)


class AsyncEvaluator:
    """Runs evaluations off the critical path: `evaluate(params, generator)`
    on the evaluator's own thread, `on_result(metrics, params, t)` after."""

    def __init__(self, evaluate: Callable[[Any, Any], dict], lifetime: ThreadLifetime,
                 on_result: Callable[[dict, Any, int], None],
                 heartbeats: Optional[HeartbeatBoard] = None):
        self._evaluate = evaluate
        self._lifetime = lifetime
        self._on_result = on_result
        self._requests: queue.Queue = queue.Queue()
        self._idle = threading.Event()
        self._idle.set()
        # Guards the (queue state, _idle) pair: submit makes the queue
        # non-empty and clears _idle at once, _maybe_set_idle sets _idle only
        # while the queue is observably empty.
        self._idle_lock = threading.Lock()
        self.heartbeats = heartbeats if heartbeats is not None else HeartbeatBoard()
        self._depth = get_registry().gauge("stoix_tpu_sebulba_queue_depth",
                                           "Items currently buffered per Sebulba queue")
        self.thread = threading.Thread(target=self._run, name="async-evaluator", daemon=True)

    def submit(self, params: Any, generator: Any, t: int) -> None:
        with self._idle_lock:
            self._idle.clear()
            self._requests.put((params, generator, t))
        self._depth.set(self._requests.qsize(), {"queue": "eval_requests"})

    def _maybe_set_idle(self) -> None:
        with self._idle_lock:
            if self._requests.empty():
                self._idle.set()

    def _run(self) -> None:
        # Drain on stop: requests still queued at a stop are finished first
        # (the run's last evaluation is submitted just before the loop ends).
        while not (self._lifetime.should_stop() and self._requests.empty()):
            try:
                params, generator, t = self._requests.get(timeout=1.0)
            except queue.Empty:
                self._maybe_set_idle()
                continue
            self._depth.set(self._requests.qsize(), {"queue": "eval_requests"})
            try:
                with span("async_eval", t=t):
                    metrics = self._evaluate(params, generator)
                    self._on_result(metrics, params, t)
                self.heartbeats.beat("evaluator")
            except Exception:  # noqa: BLE001 — a lost eval window must not kill
                # the thread silently nor wedge shutdown on a cleared _idle.
                get_registry().counter(EVALUATOR_ERRORS,
                                       "Async evaluation requests that raised").inc()
                logging.getLogger("stoix_tpu_torch.sebulba").error(
                    "[async-evaluator] eval at t=%d FAILED:\n%s", t, traceback.format_exc())
            self._maybe_set_idle()
        self._maybe_set_idle()

    def wait_until_idle(self, timeout: float = 600.0) -> None:
        """Block until every submitted evaluation completed; a timeout raises
        EvaluatorStallError with the evaluator's last-heartbeat age."""
        if not self._idle.wait(timeout=timeout):
            raise EvaluatorStallError(timeout, self.heartbeats.age("evaluator"),
                                      self._requests.qsize())
