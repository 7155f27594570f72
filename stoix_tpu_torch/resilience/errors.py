"""Typed failures (counterpart of stoix_tpu/resilience/errors.py).

`DivergenceError` (the update guard's `halt`, resilience/guards.py);
Sebulba's `ComponentFailure` and `EvaluatorStallError` (sebulba/core.py,
resilience/supervisor.py); `InjectedFault` (resilience/faultinject.py);
`CheckpointIntegrityError` (the restore's typed rejections,
utils/checkpointing.py); `StateCorruptionError` (the integrity sentinel,
resilience/integrity.py); and the preflight family, `PreflightError` with
`BackendUnavailableError`, `ConfigValidationError` (also raised by
`parallel/distributed.py` for a half-configured multi-process launch),
`ResourcePreflightError` and `CompileStallError` (resilience/preflight.py,
resilience/watchdog.py); and the fleet family, `FleetError` with
`FleetPartitionError` and `FleetBarrierTimeout` (resilience/fleet.py). The
messages are the JAX package's. This module imports nothing from the rest of
the package.
"""

from __future__ import annotations

from typing import Optional


class DivergenceError(RuntimeError):
    """Raised on the host by `system.update_guard=halt` once a window's metrics
    are materialised and the guard flagged a non-finite loss or global
    grad-norm. Names the step, the loss and the offending metric."""

    def __init__(self, step: int, loss: float, grad_norm: float, metric: str):
        self.step = int(step)
        self.loss = float(loss)
        self.grad_norm = float(grad_norm)
        self.metric = metric
        super().__init__(
            f"learner diverged at step {self.step}: non-finite {metric} "
            f"(loss={self.loss}, grad_norm={self.grad_norm}); the guarded "
            f"update was NOT applied (update_guard=halt). Re-run with "
            f"system.update_guard=skip to drop bad updates instead of halting."
        )


class ComponentFailure(RuntimeError):
    """Poison-pill for Sebulba: a component (actor thread, evaluator) failed
    unrecoverably. Propagated through the OnPolicyPipeline and
    ParameterServer queues so the peer FAILS FAST on its next get instead of
    burning a full collect timeout against a dead producer."""

    def __init__(self, component: str, reason: str, cause: Optional[BaseException] = None):
        self.component = component
        self.reason = reason
        self.__cause__ = cause
        detail = f": {type(cause).__name__}: {cause}" if cause is not None else ""
        super().__init__(f"{component} failed unrecoverably ({reason}){detail}")


class EvaluatorStallError(RuntimeError):
    """AsyncEvaluator.wait_until_idle timed out: evaluation work is still in
    flight (or wedged) at shutdown. Carries the evaluator's last-heartbeat
    age so the caller can tell slow-but-alive from dead."""

    def __init__(self, timeout: float, heartbeat_age: Optional[float], pending: int):
        self.timeout = float(timeout)
        self.heartbeat_age = heartbeat_age
        self.pending = int(pending)
        age = ("never completed an evaluation" if heartbeat_age is None
               else f"last finished one {heartbeat_age:.1f}s ago")
        super().__init__(
            f"async evaluator still busy after {timeout:.0f}s ({pending} request(s) "
            f"queued; {age}) — shutdown would drop in-flight evaluation work")


class InjectedFault(RuntimeError):
    """Raised by the fault-injection harness (resilience/faultinject.py) at an
    armed injection point. Distinct from real failures so supervision tests
    can assert the recovery path fired on THIS fault and not a genuine bug."""


class CheckpointIntegrityError(RuntimeError):
    """A restored checkpoint failed validation. `kind` names the distinct
    rejection class — 'structure' (tree/leaf/dtype mismatch), 'non_finite'
    (NaN/inf where the template is finite), or 'digest' (on-disk bytes no
    longer match the per-leaf sha256 manifest recorded at save time:
    bit-rot) — so the fallback walk's log and
    `Checkpointer.last_restore_report` carry typed reasons, not prose.
    Restore falls back to the newest VALID checkpoint when one exists; this
    error surfaces only when no candidate passes."""

    def __init__(self, step: int, reason: str, kind: str = "structure"):
        self.step = int(step)
        self.reason = reason
        self.kind = str(kind)
        super().__init__(
            f"checkpoint at step {step} failed integrity validation "
            f"[{self.kind}]: {reason}"
        )


class StateCorruptionError(RuntimeError):
    """The state-integrity sentinel (resilience/integrity.py) proved silent state corruption: either the per-device replica
    fingerprints of a replicated state group disagree (`kind=
    'replica_mismatch'` — an HBM bit-flip or a wrong-math core broke the
    post-pmean bit-identity invariant; names the deviating device(s) and
    process(es)), or the determinism probe's replay of a recorded
    (state, minibatch) pair through the learn step no longer matches its
    recorded output fingerprint (`kind='determinism'` — wrong math even at
    replica count 1). The values involved are FINITE — no divergence guard
    or finiteness check can see this class. The handling path records the
    offender in the quarantine file and exits with
    integrity.EXIT_CODE_STATE_CORRUPTION (88) so a supervising launcher
    restores the newest digest-verified checkpoint."""

    def __init__(
        self,
        kind: str,
        groups: list,
        devices: list,
        processes: list,
        window: int,
        step: int,
        detail: str = "",
    ):
        self.kind = str(kind)
        self.groups = [str(g) for g in groups]
        self.devices = [int(d) for d in devices]
        self.processes = sorted(int(p) for p in processes)
        self.window = int(window)
        self.step = int(step)
        self.detail = detail
        if self.kind == "determinism":
            what = (
                f"learn-step replay diverged from its recorded fingerprint "
                f"for state group(s) {', '.join(self.groups)} — the same "
                f"compiled program on the same input computed a different "
                f"answer (wrong-math core)"
            )
        else:
            names = ", ".join(f"device {d}" for d in self.devices) or "unknown device"
            procs = ", ".join(f"process {p}" for p in self.processes)
            what = (
                f"replica fingerprints of state group(s) "
                f"{', '.join(self.groups)} diverge at window {self.window} "
                f"(step {self.step}): {names} (on {procs}) disagree(s) with "
                f"the fleet majority — the post-pmean bit-identity invariant "
                f"is broken (HBM bit-flip or wrong-math core)"
            )
        super().__init__(
            f"silent state corruption detected: {what}"
            f"{(' — ' + detail) if detail else ''}. Recovery: restore the "
            f"newest digest-verified checkpoint and quarantine the offending "
            f"host (launcher.py --supervise relaunches on exit code 88)."
        )


class PreflightError(RuntimeError):
    """Base class for launch-hardening failures (resilience/preflight.py): the run was aborted BEFORE (or during) its first
    window by a preflight check or watchdog, with a typed cause — never by an
    indefinite hang or an anonymous 20-minutes-later OOM."""


class BackendUnavailableError(PreflightError):
    """The subprocess-isolated backend probe never got a healthy answer from
    the device runtime: every attempt timed out (wedged PJRT init) or errored.
    Names the attempt count and the per-attempt deadline so the operator can
    tell 'chip wedged after N retries' from a config mistake."""

    def __init__(self, attempts: int, timeout_s: float, last_error: str):
        self.attempts = int(attempts)
        self.timeout_s = float(timeout_s)
        self.last_error = last_error
        super().__init__(
            f"device backend unavailable: {attempts} probe attempt(s) failed "
            f"({timeout_s:.0f}s deadline each); last failure: {last_error}. "
            f"The probe runs in a SUBPROCESS, so the wedged runtime never "
            f"touched this process — safe to retry or fall back."
        )


class ConfigValidationError(PreflightError):
    """Config cross-validation (arch × system × network × env) failed before
    any device work. Carries ALL findings, not just the first, so one preflight
    run fixes the whole config."""

    def __init__(self, findings: list):
        self.findings = list(findings)
        lines = "\n".join(f"  - {f}" for f in self.findings)
        super().__init__(
            f"config validation failed with {len(self.findings)} finding(s):\n{lines}"
        )


class ResourcePreflightError(PreflightError):
    """The memory gate finds the run cannot fit the device: the predicted
    bytes, or (`basis="measured"`) the first window's measured peak, exceed
    the budget (the device's total memory × headroom). Aborting here costs
    seconds; an out-of-memory error mid-run costs the run."""

    def __init__(self, predicted_bytes: int, limit_bytes: int, headroom: float,
                 device_kind: str, detail: str = "", basis: str = "predicted"):
        self.predicted_bytes = int(predicted_bytes)
        self.limit_bytes = int(limit_bytes)
        self.headroom = float(headroom)
        self.device_kind = device_kind
        gib = 1024.0 ** 3
        super().__init__(
            f"{basis} device memory {predicted_bytes / gib:.2f} GiB exceeds "
            f"{headroom:.0%} of the {limit_bytes / gib:.2f} GiB HBM on "
            f"{device_kind}{(' (' + detail + ')') if detail else ''} — shrink "
            f"arch.total_num_envs / system.rollout_length / the network, or "
            f"raise arch.preflight.hbm_headroom if the estimate is known-loose"
        )


class CompileStallError(PreflightError):
    """A watchdog deadline expired around the first compile (in the port, the
    kernels' build) or the first window's execution (resilience/watchdog.py).
    Carries the stage name, the deadline,
    and the all-thread stack dump taken at expiry, so a wedged backend leaves
    a diagnosis instead of an indefinite hang."""

    def __init__(self, stage: str, deadline_s: float, dump: Optional[str] = None):
        self.stage = stage
        self.deadline_s = float(deadline_s)
        self.dump = dump
        knob = (
            "compile_deadline_s"
            if "compile" in stage
            else "first_window_deadline_s"
        )
        super().__init__(
            f"'{stage}' exceeded its {deadline_s:.0f}s watchdog deadline — "
            f"backend likely wedged (thread stacks + registry snapshot were "
            f"dumped to the stoix_tpu.resilience log). Raise "
            f"arch.preflight.{knob} if this shape legitimately "
            f"compiles/executes slower."
        )


class FleetError(RuntimeError):
    """Base class for cross-process fleet-coordination failures
    (resilience/fleet.py): a multi-process run lost a peer, a cross-process
    barrier blew its deadline, or agreement could not be reached. Typed, so a
    supervising launcher and the drills branch on the failure class instead
    of scraping a hung collective."""


class FleetPartitionError(FleetError):
    """A peer process stopped heartbeating (or never answered an agreement
    vote) past the configured deadline: the fleet is partitioned and every
    pending collective would hang forever. Names the missing process(es).
    The handling path writes a local-shard emergency checkpoint and exits
    with EXIT_CODE_FLEET_PARTITION so a supervisor can relaunch at the
    surviving topology."""

    def __init__(self, missing_processes: list, deadline_s: float, detail: str = ""):
        self.missing_processes = sorted(int(p) for p in missing_processes)
        self.deadline_s = float(deadline_s)
        self.detail = detail
        names = ", ".join(f"process {p}" for p in self.missing_processes) or "unknown peer"
        super().__init__(
            f"fleet partition: {names} silent past the {deadline_s:.0f}s "
            f"deadline{(' (' + detail + ')') if detail else ''} — every "
            f"cross-host collective would hang; writing a local-shard "
            f"emergency checkpoint and exiting with the fleet exit code so a "
            f"supervisor can relaunch at the surviving topology"
        )


class FleetBarrierTimeout(FleetError):
    """A cross-process barrier (fleet.guarded_barrier) exceeded its
    deadline: at least one peer never arrived. Carries the barrier name, the
    deadline, and the watchdog's all-thread stack dump taken at expiry."""

    def __init__(self, barrier: str, deadline_s: float, dump: Optional[str] = None):
        self.barrier = barrier
        self.deadline_s = float(deadline_s)
        self.dump = dump
        super().__init__(
            f"fleet barrier '{barrier}' not released within its "
            f"{deadline_s:.0f}s deadline — a peer never arrived (dead host or "
            f"wedged collective); thread stacks were dumped to the "
            f"stoix_tpu.resilience log. Raise arch.fleet.barrier_deadline_s "
            f"if this barrier legitimately takes longer."
        )
