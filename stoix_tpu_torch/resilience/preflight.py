"""Launch preflight (counterpart of stoix_tpu/resilience/preflight.py): fail
fast, with a typed error, before the run commits to the card.

A wedged CUDA runtime hangs the first CUDA call in native code, where no Python
timeout reaches. So every risky probe runs outside this process:

  1. `probe_backend`: a child process (`sys.executable -c`, torch only)
     initialises CUDA, checks a 128x128 product on the card, and prints its
     platform, name, card count and total bytes as one JSON line. The parent
     bounds each attempt with a timeout and retries with exponential
     backoff; when every attempt fails it raises `BackendUnavailableError`.
     The `backend_wedge` fault sleeps in the child before CUDA is touched.
     Without a card the child runs the product on the CPU and reports
     platform "cpu".
  2. `validate_config`: arch x system x network x env checks against the
     number of devices the run's mesh spans, before any device work; every
     finding goes into one `ConfigValidationError`.
  3. The memory gate, in two halves. Eager PyTorch has no compiled memory
     analysis, so the half before the run (`check_device_memory`) gates a
     lower bound: the built learner state's bytes plus the rollout's storage
     from the config's shapes (`predict_memory`), against the card's total
     memory x `hbm_headroom`; it refuses only a run whose state and rollout
     alone cannot fit. The half that sees the whole run
     (`check_window_peak`) gates window 0's measured peak, what the caching
     allocator reserved (activations, gradients and the libraries'
     workspaces among it), before window 1 runs and before anything is
     saved. Either raises `ResourcePreflightError`. On the CPU they log and
     pass, as the JAX package does without a `bytes_limit`.

`run_preflight` strings the stages into a `PreflightReport` (pass, fail or
skip a stage, and a one-page render). Everything is behind
`arch.preflight.enabled`: off, no child is spawned and the loop is the same.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from stoix_tpu_torch.observability import get_logger, get_registry
from stoix_tpu_torch.resilience.errors import (
    BackendUnavailableError,
    ConfigValidationError,
    ResourcePreflightError,
)

# The child: no import of this package, torch only. The backend_wedge fault
# is honoured here, before CUDA is touched.
PROBE_SOURCE = r"""
import json, os, sys, time
for entry in os.environ.get("STOIX_TPU_FAULT", "").split(","):
    if entry.strip().partition(":")[0].strip() == "backend_wedge":
        time.sleep(3600)  # a wedged runtime: alive, silent, never answers
import torch
cuda = torch.cuda.is_available()
device = torch.device("cuda", 0) if cuda else torch.device("cpu")
x = torch.ones((128, 128), device=device) @ torch.ones((128, 128), device=device)
value = float(x[0, 0].item())
if value != 128.0:
    raise SystemExit(f"probe product returned {value}, expected 128.0")
print(json.dumps({
    "platform": "cuda" if cuda else "cpu",
    "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
    "device_count": torch.cuda.device_count() if cuda else 1,
    "process_count": 1,
    "hbm_bytes_limit": torch.cuda.mem_get_info(0)[1] if cuda else None,
}))
"""


class BackendProbe(NamedTuple):
    """A healthy backend's report from the child."""

    platform: str  # "cuda" or "cpu"
    device_kind: str  # torch.cuda.get_device_name(0), or "cpu"
    device_count: int
    process_count: int
    hbm_bytes_limit: Optional[int]  # the card's total bytes (None on the CPU)
    attempts: int  # attempts consumed (1: the first answered)
    elapsed_s: float


def probe_backend(
    timeout_s: float = 60.0,
    attempts: int = 3,
    backoff_base_s: float = 1.0,
    backoff_max_s: float = 30.0,
    env: Optional[dict] = None,
) -> BackendProbe:
    """Probe the backend in a child process with a bounded timeout an
    attempt and exponential-backoff retries; the parent never blocks past
    `attempts * timeout_s` plus the backoffs. Raises BackendUnavailableError
    when every attempt fails."""
    from stoix_tpu_torch.resilience import faultinject

    log = get_logger("stoix_tpu_torch.resilience")
    counter = get_registry().counter(
        "stoix_tpu_preflight_probe_attempts_total",
        "Backend probe subprocess attempts, by outcome",
    )
    child_env = {**os.environ, **(env or {})}
    # The child reads only STOIX_TPU_FAULT: a backend_wedge armed through
    # arch.fault_spec must reach it too.
    if faultinject.backend_wedge_armed() and not child_env.get(faultinject.ENV_VAR):
        child_env[faultinject.ENV_VAR] = "backend_wedge"
    start = time.monotonic()
    last_error = "never attempted"
    for attempt in range(1, int(attempts) + 1):
        try:
            proc = subprocess.run([sys.executable, "-c", PROBE_SOURCE], capture_output=True,
                                  text=True, timeout=float(timeout_s), env=child_env)
        except subprocess.TimeoutExpired:
            counter.inc(labels={"outcome": "timeout"})
            last_error = f"probe timed out after {timeout_s:.0f}s (wedged backend init)"
        else:
            if proc.returncode == 0:
                for line in proc.stdout.strip().splitlines():
                    if not line.startswith("{"):
                        continue
                    payload = json.loads(line)
                    counter.inc(labels={"outcome": "ok"})
                    return BackendProbe(
                        platform=str(payload["platform"]),
                        device_kind=str(payload.get("device_kind", payload["platform"])),
                        device_count=int(payload["device_count"]),
                        process_count=int(payload.get("process_count", 1)),
                        hbm_bytes_limit=payload.get("hbm_bytes_limit"),
                        attempts=attempt,
                        elapsed_s=time.monotonic() - start,
                    )
                counter.inc(labels={"outcome": "bad_output"})
                last_error = f"probe exited 0 without a JSON report: {proc.stdout[-200:]!r}"
            else:
                counter.inc(labels={"outcome": "error"})
                tail = (proc.stderr or proc.stdout).strip().splitlines()
                last_error = f"probe exited {proc.returncode}: {tail[-1] if tail else 'no output'}"
        if attempt < int(attempts):
            backoff = min(float(backoff_base_s) * (2 ** (attempt - 1)), float(backoff_max_s))
            log.warning("[preflight] backend probe attempt %d/%d failed (%s) — retrying in "
                        "%.1fs", attempt, attempts, last_error, backoff)
            time.sleep(backoff)
    raise BackendUnavailableError(int(attempts), float(timeout_s), last_error)


def multi_process_launch(config: Any) -> bool:
    """Whether the launch spans several processes (torchrun's WORLD_SIZE or
    MASTER_ADDR, or `arch.distributed`): the probe child sees only this
    host's cards then, so the device-count checks are skipped."""
    arch = config.get("arch") or {}
    world = os.environ.get("WORLD_SIZE")
    return bool((world and int(world) > 1) or os.environ.get("MASTER_ADDR")
                or (arch.get("distributed") or {}).get("coordinator_address"))


def _check_mesh(findings: List[str], arch: Any, device_count: Optional[int]) -> int:
    """The mesh's data-axis size for the divisibility checks; findings for
    axes that do not cover the devices. 1 when it cannot be resolved."""
    axes = dict(arch.get("mesh") or {"data": -1})
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        findings.append(f"arch.mesh: at most one axis may be -1, got {axes}")
        return 1
    if device_count is not None:
        known = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
        if -1 in sizes:
            if known <= 0 or device_count % known != 0:
                findings.append(f"arch.mesh {axes}: fixed axes ({known}) do not divide the "
                                f"{device_count} probed devices")
                return 1
            sizes[sizes.index(-1)] = device_count // known
        elif known != device_count:
            findings.append(f"arch.mesh {axes} covers {known} devices but the backend probe "
                            f"reports {device_count}")
    data = dict(zip(axes.keys(), sizes)).get("data", 1)
    return max(1, int(data) if data != -1 else 1)


def validate_config(config: Any, device_count: Optional[int] = None) -> None:
    """Cross-validate arch x system x network x env before any device work,
    against `device_count` devices (the run's mesh: one process drives one
    card); None skips the device-dependent checks, as does a multi-process
    launch. Raises one ConfigValidationError with every finding; the
    findings are the JAX package's for the same config."""
    from stoix_tpu_torch.resilience import faultinject, guards

    findings: List[str] = []
    arch = config.get("arch") or {}
    system = config.get("system") or {}
    if device_count is not None and multi_process_launch(config):
        get_logger("stoix_tpu_torch.resilience").info(
            "[preflight] multi-process launch configured — the probed count (%d) is "
            "host-local; skipping device-count checks", device_count)
        device_count = None

    total_num_envs = arch.get("total_num_envs")
    if not isinstance(total_num_envs, int) or total_num_envs <= 0:
        findings.append(f"arch.total_num_envs must be a positive int, got {total_num_envs!r}")
        total_num_envs = None
    rollout_length = system.get("rollout_length")
    if not isinstance(rollout_length, int) or rollout_length <= 0:
        findings.append(f"system.rollout_length must be a positive int, got {rollout_length!r}")
    if arch.get("total_timesteps") in (None, "~") and arch.get("num_updates") in (None, "~"):
        findings.append("set either arch.total_timesteps or arch.num_updates (both are unset)")

    if str(arch.get("architecture_name", "anakin")) == "sebulba":
        from stoix_tpu_torch.parallel.roles import MeshRolesError, resolve_assignments

        n_actor_devices = None
        try:
            assignments = resolve_assignments(config, device_count=device_count)
            act = assignments.get("act")
            if act is not None:
                if act.device_ids is not None:
                    n_actor_devices = len(act.device_ids)
                elif device_count is not None:
                    n_actor_devices = device_count
        except MeshRolesError as exc:
            findings.extend(exc.findings)
        if n_actor_devices is None:
            n_actor_devices = len(list((arch.get("actor") or {}).get("device_ids") or []))
        actors_per_device = int((arch.get("actor") or {}).get("actor_per_device", 1) or 1)
        num_actors = max(1, n_actor_devices) * max(1, actors_per_device)
        if total_num_envs is not None and total_num_envs % num_actors != 0:
            findings.append(
                f"arch.total_num_envs ({total_num_envs}) must be divisible by num_actors "
                f"({n_actor_devices} device(s) x {actors_per_device} actor(s)/device = "
                f"{num_actors})")
    else:
        data_shards = _check_mesh(findings, arch, device_count)
        update_batch_size = int(arch.get("update_batch_size", 1) or 1)
        if update_batch_size <= 0:
            findings.append(f"arch.update_batch_size must be positive, got {update_batch_size}")
            update_batch_size = 1
        divisor = data_shards * update_batch_size
        if total_num_envs is not None and total_num_envs % divisor != 0:
            findings.append(
                f"arch.total_num_envs ({total_num_envs}) must be divisible by "
                f"data_shards * update_batch_size ({data_shards} * {update_batch_size})")
        num_minibatches = system.get("num_minibatches")
        if (isinstance(num_minibatches, int) and num_minibatches > 0
                and total_num_envs is not None and isinstance(rollout_length, int)
                and rollout_length > 0):
            per_shard = (rollout_length * total_num_envs) // divisor
            if per_shard % num_minibatches != 0:
                findings.append(
                    f"per-shard batch (rollout_length * envs_per_shard = {per_shard}) not "
                    f"divisible by system.num_minibatches ({num_minibatches})")

    try:
        guards.resolve_mode(config)
    except ValueError as exc:
        findings.append(str(exc))
    try:
        faultinject.parse_spec(arch.get("fault_spec"))
    except ValueError as exc:
        findings.append(f"arch.fault_spec: {exc}")

    env_cfg = config.get("env") or {}
    scenario = env_cfg.get("scenario")
    scenario_name = scenario.get("name") if hasattr(scenario, "get") else scenario
    # Adapter-backed suites resolve their ids against external catalogs.
    first_party = str(env_cfg.get("env_name", "")) not in ("cvec", "envpool", "gymnasium")
    if scenario_name and first_party:
        from stoix_tpu_torch.envs.registry import ENV_REGISTRY

        if str(scenario_name) not in ENV_REGISTRY:
            findings.append(
                f"env scenario '{scenario_name}' not in the first-party registry (known: "
                f"{sorted(ENV_REGISTRY)}); a typo here otherwise surfaces as a KeyError after "
                "backend init")

    network = config.get("network") or {}
    for net_name, net in network.items():
        if not hasattr(net, "items"):
            continue
        for part_name, part in net.items():
            if not hasattr(part, "get"):
                continue
            sizes = part.get("layer_sizes")
            if sizes is not None and (not isinstance(sizes, (list, tuple))
                                      or any(not isinstance(s, int) or s <= 0 for s in sizes)):
                findings.append(f"network.{net_name}.{part_name}.layer_sizes must be positive "
                                f"ints, got {sizes!r}")

    if findings:
        raise ConfigValidationError(findings)


def tensor_bytes(tree: Any) -> int:
    """The bytes of every tensor of a tree."""
    from stoix_tpu_torch.utils.tree import tree_leaves

    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree))


def predict_memory(learner_state: Any, config: Any, observation: Any) -> dict:
    """The gate's lower bound for an on-policy window: the learner state's
    tensor bytes plus the rollout's storage from the config's shapes,
    `rollout_length` x `total_num_envs` transitions of two observations
    (`obs`, `next_obs`; `observation` is one env's) and eight 4-byte scalars
    (action, value, reward, log-prob, done, truncated, two episode metrics).
    Activations, gradients and the libraries' workspaces come on top: window
    0's measured peak (`check_window_peak`) holds those."""
    state_bytes = tensor_bytes(learner_state)
    steps = int(config.system.get("rollout_length", 1)) * int(config.arch.total_num_envs)
    rollout_bytes = steps * (2 * tensor_bytes(observation) + 8 * 4)
    return {"predicted_bytes": state_bytes + rollout_bytes,
            "state_bytes": state_bytes, "rollout_bytes": rollout_bytes}


def check_device_memory(estimate: dict, device: Any, headroom: float = 0.9,
                        limit_bytes: Optional[int] = None) -> dict:
    """Gate a prediction (`predict_memory`) on the card's total memory (or
    `limit_bytes`): ResourcePreflightError when it is above `headroom` of it.
    On the CPU, with no limit given, it logs and passes. Returns the estimate
    with `limit_bytes` when there is one."""
    log = get_logger("stoix_tpu_torch.resilience")
    device = torch.device(device)
    gib = 1024.0 ** 3
    if limit_bytes is None and device.type == "cuda":
        limit_bytes = int(torch.cuda.mem_get_info(device)[1])
    if not limit_bytes:
        log.info("[preflight] predicted run memory %.3f GiB (the CPU exposes no limit — gate "
                 "skipped)", estimate["predicted_bytes"] / gib)
        return estimate
    estimate = {**estimate, "limit_bytes": int(limit_bytes)}
    get_registry().gauge(
        "stoix_tpu_preflight_predicted_memory_bytes",
        "The memory gate's prediction for the run (state plus rollout storage)",
    ).set(float(estimate["predicted_bytes"]))
    if estimate["predicted_bytes"] > float(headroom) * float(limit_bytes):
        kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
        raise ResourcePreflightError(
            estimate["predicted_bytes"], int(limit_bytes), float(headroom), kind,
            detail=f"state={estimate['state_bytes'] / gib:.2f} GiB, "
            f"rollout={estimate['rollout_bytes'] / gib:.2f} GiB")
    log.info("[preflight] predicted run memory %.3f GiB fits %.0f%% of %.2f GiB",
             estimate["predicted_bytes"] / gib, headroom * 100, limit_bytes / gib)
    return estimate


def check_window_peak(memory: dict, peak_bytes: int, headroom: float = 0.9,
                      device_kind: str = "cuda") -> dict:
    """The measured half of the gate: window 0's peak (the most the caching
    allocator reserved, `torch.cuda.max_memory_reserved`) against `headroom`
    of `memory["limit_bytes"]`, the limit `check_device_memory` found.
    ResourcePreflightError when above; without a limit, it passes. Returns
    `memory` with the peak."""
    memory = {**memory, "first_window_reserved_peak_bytes": int(peak_bytes)}
    limit_bytes = memory.get("limit_bytes")
    if limit_bytes and peak_bytes > float(headroom) * float(limit_bytes):
        raise ResourcePreflightError(
            int(peak_bytes), int(limit_bytes), float(headroom), device_kind,
            detail="window 0's peak, reserved by the caching allocator; checked before "
            "window 1 and before any save", basis="measured")
    return memory


class PreflightSettings(NamedTuple):
    """Resolved `arch.preflight` block (defaults applied). The deadlines
    cover a cold build of the kernels (under a minute on the H100)."""

    enabled: bool
    probe_timeout_s: float
    probe_attempts: int
    probe_backoff_base_s: float
    probe_backoff_max_s: float
    hbm_headroom: float
    compile_deadline_s: float
    first_window_deadline_s: float
    hard_exit_grace_s: float


def settings_from_config(config: Any) -> PreflightSettings:
    cfg = (config.get("arch") or {}).get("preflight") or {}
    return PreflightSettings(
        enabled=bool(cfg.get("enabled", False)),
        probe_timeout_s=float(cfg.get("probe_timeout_s", 60.0)),
        probe_attempts=int(cfg.get("probe_attempts", 3)),
        probe_backoff_base_s=float(cfg.get("probe_backoff_base_s", 1.0)),
        probe_backoff_max_s=float(cfg.get("probe_backoff_max_s", 30.0)),
        hbm_headroom=float(cfg.get("hbm_headroom", 0.9)),
        compile_deadline_s=float(cfg.get("compile_deadline_s", 1800.0)),
        first_window_deadline_s=float(cfg.get("first_window_deadline_s", 900.0)),
        hard_exit_grace_s=float(cfg.get("hard_exit_grace_s", 0.0)),
    )


class PreflightReport:
    """Stage-by-stage outcome: (name, status, detail) rows, status 'pass',
    'fail' or 'skip'. `ok` ignores skips; `render()` is the one-page text."""

    def __init__(self) -> None:
        self.stages: List[tuple] = []

    def add(self, name: str, status: str, detail: str = "") -> None:
        if status not in ("pass", "fail", "skip"):
            raise ValueError(f"preflight stage status {status!r}")
        self.stages.append((name, status, detail))

    @property
    def ok(self) -> bool:
        return all(status != "fail" for _name, status, _detail in self.stages)

    def render(self) -> str:
        mark = {"pass": "PASS", "fail": "FAIL", "skip": "skip"}
        width = max((len(n) for n, _s, _d in self.stages), default=8)
        lines = ["stoix_tpu_torch preflight report", "=" * 40]
        for name, status, detail in self.stages:
            lines.append(f"{name.ljust(width)}  [{mark[status]}]  {detail}".rstrip())
        lines.append("=" * 40)
        lines.append(f"overall: {'PASS' if self.ok else 'FAIL'}")
        return "\n".join(lines)


def run_preflight(configs: Any = None,
                  settings: Optional[PreflightSettings] = None) -> PreflightReport:
    """Probe the backend, then validate each config against one device (one
    process drives one card). `configs` is one config, a list of (label,
    config) pairs, or None (probe only)."""
    settings = settings or PreflightSettings(True, 60.0, 3, 1.0, 30.0, 0.9, 1800.0, 900.0, 0.0)
    report = PreflightReport()
    device_count: Optional[int] = None
    try:
        probe = probe_backend(timeout_s=settings.probe_timeout_s,
                              attempts=settings.probe_attempts,
                              backoff_base_s=settings.probe_backoff_base_s,
                              backoff_max_s=settings.probe_backoff_max_s)
        device_count = 1
        report.add("backend_probe", "pass",
                   f"{probe.platform} x{probe.device_count} ({probe.device_kind}), attempt "
                   f"{probe.attempts}, {probe.elapsed_s:.1f}s")
    except BackendUnavailableError as exc:
        report.add("backend_probe", "fail", str(exc))
    if configs is None:
        report.add("config_validation", "skip", "no configs supplied")
        return report
    pairs = configs if isinstance(configs, list) else [("config", configs)]
    for label, config in pairs:
        try:
            validate_config(config, device_count=device_count)
            report.add(f"config[{label}]", "pass", "arch/system/network/env cross-checks")
        except ConfigValidationError as exc:
            report.add(f"config[{label}]", "fail", "; ".join(exc.findings))
    return report
