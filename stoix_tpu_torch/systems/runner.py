"""Shared Anakin host loop (counterpart of
stoix_tpu/systems/runner.py::run_anakin_experiment, synchronous only, and
of its recurrent form `run_rnn_anakin_experiment`).

Per eval window: run `num_updates_per_eval` learner updates, wait for the
device, evaluate the new actor params, log, and keep the best params; after
the last window, the absolute metric evaluates the best params over
`absolute_metric_multiplier` times as many episodes.

`arch.pipelined_loop` is read and this synchronous loop serves both values:
the JAX package pins the trajectory bit-identical either way, and PyTorch
gains nothing from a one-window-deep dispatch that its eager launches do not
already overlap.

Checkpointing (utils/checkpointing.py), as the JAX runner wires it: with
`logger.checkpointing.load_model` the saved state is restored into the freshly
built one before the evaluators are made (the fallback walk past unusable
steps, their count in `resilience.restore_skipped`), and the run's steps
count on from the restored step; with `save_model` each window's state is
saved after its evaluation. The update guard's host half
(resilience/guards.py) reads each window's train metrics once they are on
the host.

The operations layer of one process, as the JAX runner wires it
(stoix_tpu/systems/runner.py:250-960); every piece is off by default and
adds no work then, so a run with every switch on is the same run, bit for
bit, as with every switch off:

  * `arch.fault_spec` / `STOIX_TPU_FAULT` arms the Anakin faults
    (resilience/faultinject.py) before the learner is built.
  * The goodput ledger (observability/goodput.py) attributes the run's wall
    time from the phase clock; `LAST_RUN_STATS["goodput"]`.
  * `arch.preflight.enabled`: the backend probe in a child process and the
    config's cross-checks before any device work; the first-compile stage
    (the kernels' build, where `slow_compile` sleeps) and window 0 under
    deadline watchdogs (resilience/watchdog.py); the memory gate, its lower
    bound before window 0 and window 0's measured peak before window 1.
  * `arch.integrity.enabled`: the sentinel (resilience/integrity.py)
    fingerprints the replicated state after each learn step, gathers every
    rank's fingerprints, and raises StateCorruptionError before that
    window's checkpoint on any disagreement; with
    `determinism_probe_interval` it replays window 0's input.
  * Graceful preemption (resilience/preemption.py): SIGTERM or SIGINT stops
    the loop at the next window boundary, writes an emergency checkpoint of
    the last window's state, and returns normally.
  * The flight recorder (observability/flightrec.py) keeps one record a
    window; telemetry (`logger.telemetry.enabled`, utils/logger.py) records
    a span for each host phase.

The operations layer across processes, as the JAX runner wires it
(stoix_tpu/systems/runner.py:295-1012):

  * `arch.fleet.enabled` (resilience/fleet.py): the coordinator starts
    before the learner is built; each window stages a host copy of the state
    as the rescue candidate after the learn step, carries this rank's stop
    flag and last window wall in its own slot of the window's episode gather
    (`fetch_global`: the same one collective), confirms the candidate, and
    decides; every rank stops at the same window. A SIGTERM on one rank
    becomes its flag, and every rank drains and saves at the next window (or
    through a store vote after the last); a frozen peer trips the monitor,
    whose emergency save and exit 87 end the run; a partition seen at a
    window boundary raises FleetPartitionError.
  * A fleet emergency store as `load_path` restores through
    `fleet.restore_emergency`, with the setup's `restore_transform` (the
    population's shrink and grow, population/elastic.py) applied to its
    host arrays before placement, and a step saved by another number of
    processes through the topology-elastic restore (utils/checkpointing.py).
  * `shrink:N` and `grow:N` leave through `elastic.resize_exit` (exit 89).
  * The ops plane: the status board and the health monitor's window beat
    always (host memory only), and with `logger.telemetry.http.enabled` the
    server (observability/httpz.py), with the fleet's metrics aggregator
    behind `/metrics/fleet` when the fleet is on over several processes.

The compile-cache layer is not ported (ROADMAP A19c); its knob raises.

Data parallelism, as the JAX runner's `maybe_initialize_distributed`, mesh
and `check_total_timesteps(config, mesh.shape["data"])`: under `torchrun
--nproc-per-node N` (or `arch.distributed.*`) the runner joins the process
group, builds the mesh from `arch.mesh` (its "data" axis; `-1` is every
process) and runs ONE run sharded over the N ranks, each with
`total_num_envs // N` envs. The learners average gradients over the ranks
(systems/anakin.py). Every host decision reads values that are the same on
every rank: the train metrics are averaged over the ranks and the episode
and eval metrics gathered (`parallel.fetch_global`), so the guard, the best
params and the return decide alike everywhere; a rank-local decision would
deadlock the next collective. Only the coordinator logs and writes the
store's metadata. One process with no group runs as it always did.

Gossip learner groups (parallel/gossip.py), for a system that takes them
(`outer_axes=("group",)`, the ff_ppo family): on a ("group", "data") mesh
the data axis is each group's own (`systems/anakin.py::use_mesh`), the
setup returns a GossipPlan, and its step runs every `arch.gossip.interval`
windows after the learn step and before the eval and checkpoint snapshot,
as in the JAX runner (`gossip_s` in the phases, `stoix_tpu_gossip_rounds_total`). Every
rank evaluates group 0's params, reads every group's episodes and train
metrics, and so decides alike. One group is the plain run: its plan has no
step.

The population root (population/runner.py, `outer_axes=("pop",)`) takes a
"pop" axis beside "data" (the members spread over its ranks,
`systems/anakin.py::use_mesh` scoping the data axis to each pop rank's
own); every other system refuses `arch.mesh.pop`, naming it.
"""

from __future__ import annotations

import contextlib
import copy
import math
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Union

import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.evaluator import evaluator_setup, get_rnn_evaluator_fn
from stoix_tpu_torch.observability import (
    HeartbeatBoard, device_annotation, flightrec, get_health_monitor, get_logger, get_ops_server,
    get_registry, get_status_board, goodput, span,
)
from stoix_tpu_torch.observability import aggregate as fleet_metrics
from stoix_tpu_torch.ops import scan_kernels
from stoix_tpu_torch.parallel import (
    create_mesh, fetch_global, maybe_initialize_distributed, mesh_shape, process_count,
)
from stoix_tpu_torch.resilience import (
    PreemptionHandler, Watchdog, elastic, faultinject, fleet, guards, integrity, preflight,
)
from stoix_tpu_torch.resilience.errors import BackendUnavailableError
from stoix_tpu_torch.systems import anakin
from stoix_tpu_torch.systems.anakin import make_generator, make_seeds, rank_seed
from stoix_tpu_torch.utils.checkpointing import checkpointer_from_config, loader_from_config
from stoix_tpu_torch.utils.logger import LogEvent, StoixLogger
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps

# Stats of the most recent run_anakin_experiment call in this process, as
# the JAX runner's LAST_RUN_STATS: per-window wall seconds and env-steps/s
# (of the whole run), the logger's records, the device the run used, the
# mesh and this rank's env count, the phase breakdown and its goodput
# report, the resilience block (the guard's mode and skipped updates, the
# restored step and the rejected newer steps, whether a signal stopped the
# run, the fleet and its agreed stop), the sentinel's stats, the
# preflight's probe and memory gate, and the fleet's rescue copies. Every
# rank keeps its own.
LAST_RUN_STATS: Dict[str, Any] = {}
GOSSIP_ROUNDS = "stoix_tpu_gossip_rounds_total"


class AnakinSetup(NamedTuple):
    """What a system's learner_setup returns to the shared runner."""

    learn: Callable[[Any], Any]  # learner_state -> ExperimentOutput
    learner_state: Any
    eval_act_fn: Callable[..., Any]  # act_fn for the evaluator
    eval_params_fn: Callable[[Any], Any]  # learner_state -> params for eval
    # Optional GossipPlan (parallel/gossip.py): when its step is set, the
    # runner dispatches it every plan.interval windows right after the learn
    # step. None (the default) is lockstep.
    gossip: Any = None
    # Whether the learner runs the update guard, where the `nan_loss` fault
    # is injected (the ff_ppo family); the runner refuses the fault elsewhere.
    guarded: bool = False
    # The elastic-restore seam: a transform over a fleet emergency store's
    # digest-verified host arrays, applied before placement by tree path
    # (the population's shrink and grow). None restores the store as saved.
    restore_transform: Any = None


SetupFn = Callable[[envs.Environment, Any, torch.device, int], AnakinSetup]
# (eval_env, eval_act_fn, config) -> (evaluator, absolute_metric_evaluator)
EvaluatorSetupFn = Callable[[envs.Environment, Any, Any], Any]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device a run asked for. CUDA without a visible card raises: the
    port never carries on on the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} was asked for but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def unported_arch_keys(config: Any, outer_axes: Sequence[str] = ()) -> list:
    """The arch settings no runner of the port implements: a mesh axis other
    than "data" and the system's `outer_axes` ("group", the gossip learner
    groups of the ff_ppo family; "pop", the population root's members) and
    the compile-cache layer."""
    arch = config.arch
    taken = ("data", *outer_axes)
    unported = [f"arch.mesh.{axis}" for axis in (arch.get("mesh") or {}) if axis not in taken]
    if (arch.get("compile_cache") or {}).get("enabled", False):
        unported.append("arch.compile_cache.enabled")
    return unported


def check_ported_arch(config: Any, outer_axes: Sequence[str] = ()) -> None:
    """Raise NotImplementedError, naming the key, for an arch setting the
    port does not implement; `outer_axes` names the mesh axes beside "data"
    that the system takes. Faults are checked when they are armed
    (`faultinject.check_anakin_plan`)."""
    unported = unported_arch_keys(config, outer_axes)
    if config.arch.get("roles") not in (None, "~"):
        # Anakin colocates every role on the whole mesh, as the JAX Anakin
        # runner does; only the Sebulba runner (systems/ppo/sebulba/ff_ppo.py)
        # splits the roles.
        unported.append("arch.roles")
    if unported:
        raise NotImplementedError("not ported: " + ", ".join(unported))


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def maybe_watchdog(pf: preflight.PreflightSettings, stage: str, deadline_s: float):
    """A deadline Watchdog around `stage` when preflight is on; a free
    nullcontext otherwise (the off path adds no thread and no work)."""
    if not pf.enabled:
        return contextlib.nullcontext()
    return Watchdog(stage, deadline_s, hard_exit_grace_s=pf.hard_exit_grace_s)


def build_path_kernels(config: Any, device: torch.device) -> None:
    """The first-compile stage: build (or load) the kernels the learn step
    launches on the card before the first window. B1 is on every Anakin
    path under `system.multistep_impl: pallas`; a system's other kernels
    build at their first launch, inside window 0's watchdog."""
    if device.type != "cuda" or str(config.system.get("multistep_impl", "scan")) != "pallas":
        return
    from stoix_tpu_torch.kernels import linear_recurrence

    linear_recurrence.LIBRARY.load()


def run_preflight_checks(config: Any, pf: preflight.PreflightSettings, device: torch.device,
                         sebulba: bool = False) -> Optional[preflight.BackendProbe]:
    """The backend probe and the config's cross-checks, when preflight is
    on (None otherwise). A run asked for the card fails here when the probe
    finds none. Anakin's mesh spans processes, one device each; Sebulba's
    roles span the probed cards (a CPU run builds as many devices as its
    ids name, so its device-count checks are skipped)."""
    if not pf.enabled:
        return None
    with span("preflight"):
        probe = preflight.probe_backend(
            timeout_s=pf.probe_timeout_s, attempts=pf.probe_attempts,
            backoff_base_s=pf.probe_backoff_base_s, backoff_max_s=pf.probe_backoff_max_s)
        if device.type == "cuda" and probe.platform != "cuda":
            raise BackendUnavailableError(
                probe.attempts, pf.probe_timeout_s,
                f"the probe found platform {probe.platform!r} but the run asked for {device}")
        if sebulba:
            count = probe.device_count if device.type == "cuda" else None
        else:
            count = 1
        preflight.validate_config(config, device_count=count)
        get_logger("stoix_tpu_torch.resilience").info(
            "[preflight] backend healthy (%s x%d, attempt %d) and config cross-checks pass",
            probe.platform, probe.device_count, probe.attempts)
    return probe


def run_anakin_experiment(
    config: Any,
    setup_fn: SetupFn,
    device: Union[str, torch.device] = "cuda",
    evaluator_setup_fn: Optional[EvaluatorSetupFn] = None,
    warmup_fn: Optional[Callable[[Any], Any]] = None,
    outer_axes: Sequence[str] = (),
) -> float:
    """Generic Anakin experiment: returns the final eval episode-return mean.
    A system with its own evaluator (a stateful one) passes
    `evaluator_setup_fn`; the default is the feed-forward evaluator. An
    off-policy system passes `warmup_fn` (learner_state -> learner_state, its
    buffer pre-fill), run once on the fresh state before a restore and the
    first window, as the JAX runner runs it. A system whose setup takes a
    mesh axis beside "data" names it in `outer_axes`: "group", the gossip
    learner groups (the ff_ppo family), or "pop", the population root's
    members; every other system refuses the axis, naming it."""
    device = resolve_device(device)
    check_ported_arch(config, outer_axes)
    # Armed before the learner is built: the guard reads the nan_loss step.
    faultinject.check_anakin_plan(faultinject.configure(config.arch.get("fault_spec")))
    guard_mode = guards.resolve_mode(config)
    # The goodput ledger is open before any setup work, so restore, build and
    # stall seconds all fall inside the attributed wall.
    ledger = goodput.GoodputLedger().start()
    goodput.set_active(ledger)
    try:
        scan_kernels.configure_from_config(config)
        pf = preflight.settings_from_config(config)
        probe = run_preflight_checks(config, pf, device)
        maybe_initialize_distributed(config, device.type)
        mesh_axes = dict(config.arch.get("mesh") or {"data": -1})
        try:
            shape = mesh_shape(mesh_axes, process_count())
        except ValueError as error:
            named = ", ".join(f"arch.mesh.{axis}={size}" for axis, size in mesh_axes.items())
            raise ValueError(f"{named}: {error}") from None
        data_shards, num_groups = shape["data"], shape.get("group", 1)
        mesh = None
        if torch.distributed.is_initialized():
            if device.type == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
            mesh = create_mesh(mesh_axes, device.type)
        # The fleet (arch.fleet): heartbeats start before the learner is
        # built, so a long build on one rank never reads as a dead peer.
        fleet_coord = fleet.fleet_from_config(config)
        if fleet_coord is not None:
            fleet_coord.start()
        try:
            with anakin.use_mesh(mesh):
                return _run(config, setup_fn, device, evaluator_setup_fn, warmup_fn, guard_mode,
                            mesh, shape, data_shards, num_groups, ledger, pf, probe, fleet_coord)
        finally:
            if fleet_coord is not None:
                fleet_coord.stop()
    finally:
        goodput.set_active(None)


def _gossip_counter():
    return get_registry().counter(GOSSIP_ROUNDS, "Cross-group parameter mixing rounds dispatched")


def _run(config, setup_fn, device, evaluator_setup_fn, warmup_fn, guard_mode, mesh, shape,
         data_shards, num_groups, ledger, pf, probe, fleet_coord) -> float:
    """The host loop of `run_anakin_experiment`, with the mesh in use."""
    config = check_total_timesteps(config, data_shards)
    config.logger.system_name = config.system.system_name
    sentinel = integrity.sentinel_from_config(config)
    log = get_logger("stoix_tpu_torch.resilience")

    env, eval_env = envs.make(config)
    setup_seed, eval_seed = make_seeds(int(config.arch.seed), 2)
    setup = setup_fn(env, config, device, setup_seed)
    if faultinject.poison_step() is not None and not setup.guarded:
        raise NotImplementedError(
            f"not ported for {config.system.system_name}: arch.fault_spec / "
            f"{faultinject.ENV_VAR} fault nan_loss (its learner runs no update guard to poison; "
            "the ff_ppo family's does)")
    learner_state = setup.learner_state
    if warmup_fn is not None:
        learner_state = warmup_fn(learner_state)
    # Resume: the saved state restored into the freshly built one, before
    # the evaluators (the JAX runner's order). Its seconds are recovery.
    start_step, restore_skipped, restore_report = 0, 0, []
    elastic_restore = None
    if config.logger.checkpointing.get("load_model", False):
        started = time.perf_counter()
        load_args = config.logger.checkpointing.get("load_args") or {}
        load_path = load_args.get("load_path")
        if load_path and fleet.is_emergency_store(load_path):
            # A partition survivor's rescue store: the same placement by
            # tree path as the topology-elastic restore.
            learner_state, start_step = fleet.restore_emergency(
                learner_state, load_path, raw_transform=setup.restore_transform)
        else:
            loader = loader_from_config(config, config.system.system_name)
            loader.check_version()
            learner_state, start_step = loader.restore(learner_state, load_args.get("timestep"))
            restore_report = list(loader.last_restore_report)
            restore_skipped = len(restore_report)
            elastic_restore = loader.last_elastic_restore
        ledger.note("recovery", time.perf_counter() - started)
        get_logger("stoix_tpu_torch.checkpoint").info(
            "[checkpoint] restored state from step %d%s", start_step,
            f" ({restore_skipped} newer checkpoint(s) rejected)" if restore_skipped else "")
    eval_generator = make_generator(rank_seed(eval_seed), device)
    make_evaluators = evaluator_setup_fn or evaluator_setup
    evaluator, absolute_evaluator = make_evaluators(eval_env, setup.eval_act_fn, config)
    # StoixLogger's observability.configure is the run's reset of the flight
    # recorder: the run's context goes on the fresh ring after it.
    logger = StoixLogger(config)
    recorder = flightrec.get_flight_recorder()
    recorder.set_context(architecture="anakin", system=str(config.system.system_name),
                         seed=int(config.arch.seed))
    # The ops plane, after StoixLogger (its observability.configure is the
    # run's reset of the health monitor and starts the server with
    # logger.telemetry.http.enabled): host memory only, always on.
    http_cfg = dict(dict(config.logger.get("telemetry") or {}).get("http") or {})
    status = get_status_board()
    status.update({
        "run_id": f"{config.system.system_name}_seed{int(config.arch.seed)}",
        "architecture": "anakin", "system": str(config.system.system_name),
        "step": start_step, "restore_skipped": restore_skipped,
        "last_restore_report": restore_report,
        "quarantine_file": dict(config.arch.get("integrity") or {}).get(
            "quarantine_file", "checkpoints/quarantine.json")})
    # /healthz's source: the loop beats once a window; a stalled loop's age
    # crosses stale_after_s and the endpoint answers 503.
    monitor = get_health_monitor()
    loop_beats = HeartbeatBoard()
    monitor.register_board("anakin-host-loop", loop_beats,
                           stale_after_s=float(http_cfg.get("stale_after_s", 60.0) or 60.0))
    ops_server = get_ops_server()
    aggregator = None
    if ops_server is not None and fleet_coord is not None:
        # Every process's registry on /metrics/fleet, through the fleet's store.
        aggregator = fleet_metrics.aggregator_from_fleet(
            fleet_coord, interval_s=float(http_cfg.get("aggregate_interval_s", 10.0) or 10.0))
        if aggregator is not None:
            aggregator.start()
            ops_server.set_aggregator(aggregator)
    gossip_plan = setup.gossip
    gossip_step = gossip_plan.step if gossip_plan is not None else None
    gossip_rounds = 0
    # Under learner groups every rank reads every group's episodes (the whole
    # mesh) and train metrics (each group's data mean, gathered over "group"),
    # as the JAX runner reads the [G]-stacked outputs.
    episode_axis = None if num_groups > 1 else "data"

    steps_per_eval = (
        int(config.system.rollout_length)
        * int(config.arch.total_num_envs)
        * int(config.arch.num_updates_per_eval)
    )
    num_evaluation = int(config.arch.num_evaluation)
    phases = {"compile_s": 0.0, "learn_s": 0.0, "eval_s": 0.0, "ckpt_s": 0.0}
    best_params = setup.eval_params_fn(learner_state)
    best_return = -math.inf
    final_return = 0.0
    window_seconds = []
    skipped_base = guards.skipped_counter().value()
    preempt = PreemptionHandler()
    preempted = False
    agreed_stop: Optional[fleet.FleetDecision] = None
    window_done_at = time.perf_counter()
    last_save_t: Optional[int] = None
    dispatched_t = start_step
    memory = None
    checkpointer = None
    try:
        checkpointer = checkpointer_from_config(config, config.system.system_name)
        if sentinel is not None:
            sentinel.bind(learner_state, world=process_count())
            if checkpointer is not None:
                sentinel.set_resume_info(checkpointer.directory)
            sentinel.install_excepthook()
        # The first-compile stage: the kernels' build (a cold one takes tens
        # of seconds), under its watchdog when preflight is on.
        start = time.perf_counter()
        with span("first_compile"), maybe_watchdog(pf, "first_compile", pf.compile_deadline_s):
            faultinject.maybe_slow_compile()
            build_path_kernels(config, device)
        phases["compile_s"] = time.perf_counter() - start
        if pf.enabled:
            memory = preflight.check_device_memory(
                preflight.predict_memory(learner_state, config, env.observation_value()),
                device, headroom=pf.hbm_headroom)
            if device.type == "cuda":
                # Window 0's peak counts what the process already holds (the
                # state among it): the baseline goes beside it.
                torch.cuda.reset_peak_memory_stats(device)
                memory["allocated_before_bytes"] = int(torch.cuda.memory_allocated(device))
        preempt.install()
        if sentinel is not None and sentinel.probe_enabled:
            sentinel.capture_probe_input(learner_state)
        for eval_idx in range(num_evaluation):
            # One beat a window top: a stalled loop stops the beats.
            loop_beats.beat("window")
            faultinject.maybe_host_stall(eval_idx)
            # bitflip:N corrupts rank 0's params going into window N: only
            # the sentinel's fingerprints can see it.
            learner_state = faultinject.maybe_bitflip(learner_state, eval_idx)
            if sentinel is not None and sentinel.should_probe(eval_idx):
                probe_error = sentinel.run_probe(setup.learn)
                if probe_error is not None:
                    if fleet_coord is not None:
                        fleet_coord.request_stop(fleet.FLAG_CORRUPT, note=str(probe_error))
                    raise probe_error
            # Window 0 runs under the first-window watchdog with preflight on
            # (a card that builds but wedges on its first launch).
            first = maybe_watchdog(pf, "first_window", pf.first_window_deadline_s) if (
                eval_idx == 0) else contextlib.nullcontext()
            start = time.perf_counter()
            with first, span("learn_dispatch", window=eval_idx), \
                    device_annotation("learn_dispatch"):
                output = setup.learn(learner_state)
                _synchronize(device)
            wall = time.perf_counter() - start
            window_seconds.append(wall)
            phases["learn_s"] += wall
            learner_state = output.learner_state
            # host_loss:N freezes this process here, its learn step's
            # collectives done: its peers block in the window's gather.
            faultinject.maybe_host_loss(eval_idx)
            if eval_idx == 0 and memory is not None and device.type == "cuda":
                # The measured half of the gate, before anything reads or
                # saves this window's state and before window 1 runs.
                memory["first_window_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
                memory = preflight.check_window_peak(
                    memory, torch.cuda.max_memory_reserved(device), pf.hbm_headroom,
                    torch.cuda.get_device_name(device))
            if gossip_step is not None and (eval_idx + 1) % gossip_plan.interval == 0:
                # Mix before the snapshot: eval, best params and checkpoints
                # all observe the post-gossip parameters; the round index
                # seeds random_peer's edge.
                start = time.perf_counter()
                with span("gossip_dispatch", window=eval_idx):
                    learner_state = gossip_step(learner_state, eval_idx)
                    _synchronize(device)
                phases["gossip_s"] = phases.get("gossip_s", 0.0) + time.perf_counter() - start
                gossip_rounds += 1
                _gossip_counter().inc()
            t = start_step + (eval_idx + 1) * steps_per_eval
            dispatched_t = t
            if fleet_coord is not None:
                # The rescue candidate: a host copy enqueued behind the learn
                # step, confirmed once this window's metrics are on the host.
                fleet_coord.stage_candidate(t, learner_state)

            if sentinel is not None:
                # The verdict before anything reads this window's state: a
                # corrupt state is never evaluated as best or saved.
                payload = sentinel.fingerprints(output.learner_state)
                corruption = sentinel.verify(payload, eval_idx, t)
                if corruption is not None:
                    recorder.record("integrity_verdict", window=eval_idx, step=t,
                                    detail=str(corruption))
                    if fleet_coord is not None:
                        fleet_coord.request_stop(fleet.FLAG_CORRUPT, note=str(corruption))
                    raise corruption
                if eval_idx == 0:
                    sentinel.record_probe_reference(payload)

            # Parameters are never updated in place, so the eval params need no copy.
            start = time.perf_counter()
            with span("eval_dispatch", window=eval_idx):
                eval_params = setup.eval_params_fn(learner_state)
                eval_metrics = fetch_global(evaluator(eval_params, eval_generator), mesh)
            phases["eval_s"] += time.perf_counter() - start
            train_metrics = output.train_metrics
            if num_groups > 1:
                train_metrics = {k: torch.as_tensor(v) for k, v in fetch_global(
                    train_metrics, mesh, axis="group").items()}
            # The guard's host half: the window's metrics are on the host here;
            # update_guard=halt raises DivergenceError, naming the step.
            guards.publish_guard_metrics(guard_mode, train_metrics, t)
            # Envs along the last axis of the [updates, T, envs] episode
            # metrics. The fleet's payload rides the same gather, one slot a
            # rank over every rank (the episode gather spans the world).
            gather = {"episode": output.episode_metrics}
            if fleet_coord is not None:
                gather["fleet"] = fleet_coord.telemetry_for_fetch(device)
            fetched = fetch_global(gather, mesh, axis=episode_axis, dim=-1)
            episode_metrics = fetched["episode"]
            now = time.perf_counter()
            window_wall, window_done_at = now - window_done_at, now
            if fleet_coord is not None:
                # The window's metrics are on the host, so its copy is
                # complete: promote it, decide from every rank's flag, then
                # the skew; this window's wall goes in the next payload.
                fleet_coord.confirm_candidate(t)
                payload = fetched["fleet"]
                decision = fleet_coord.decide_from_fetch(payload, mesh)
                if decision.stop and agreed_stop is None:
                    agreed_stop = decision
                fleet_coord.skew_from_fetch(payload, mesh, eval_idx)
                fleet_coord.note_window_wall(window_wall)
            sps = steps_per_eval / wall
            get_registry().gauge("stoix_tpu_runner_steps_per_second",
                                 "Env-steps/sec over the most recent eval window").set(sps)
            status.update({"window": eval_idx, "step": t, "steps_per_second": round(sps, 3)})
            recorder.record("window", window=eval_idx, step=t, wall_s=round(wall, 6),
                            steps_per_second=round(sps, 3),
                            phases={k: round(v, 6) for k, v in phases.items()},
                            fleet=fleet_coord is not None,
                            fleet_stop=agreed_stop.describe() if agreed_stop is not None else None,
                            integrity=sentinel is not None)
            with span("log", window=eval_idx):
                logger.log({**envs.get_final_step_metrics(episode_metrics),
                            "steps_per_second": sps}, t, eval_idx, LogEvent.ACT)
                logger.log({k: v.mean() for k, v in train_metrics.items()}, t, eval_idx,
                           LogEvent.TRAIN)
                logger.log(eval_metrics, t, eval_idx, LogEvent.EVAL)
            mean_return = float(eval_metrics["episode_return"].mean())
            final_return = mean_return
            if mean_return >= best_return:
                best_return = mean_return
                best_params = eval_params
            if checkpointer is not None:
                start = time.perf_counter()
                with span("ckpt_save", window=eval_idx):
                    if checkpointer.save(t, learner_state, mean_return):
                        last_save_t = t
                phases["ckpt_s"] += time.perf_counter() - start
            faultinject.maybe_sigterm(eval_idx)
            # shrink:N / grow:N vacate for another topology once this
            # window's candidate is confirmed: the relaunch restores it.
            resize_action = faultinject.maybe_resize(eval_idx)
            if resize_action is not None:
                elastic.resize_exit(resize_action, config=config, window_idx=eval_idx,
                                    step=dispatched_t, fleet_coord=fleet_coord,
                                    device_count=process_count(), platform=device.type)
            if fleet_coord is None:
                if preempt.stop_requested():
                    preempted = True
                    break
            else:
                # Never stop alone: a local stop request is this rank's flag
                # in the next window's gather, and every rank breaks on the
                # same decision. A partition the monitor declared while this
                # thread ran Python surfaces here, typed.
                fleet_coord.check_partition()
                if preempt.stop_requested():
                    fleet_coord.request_stop(
                        fleet.FLAG_PREEMPT, note=f"{preempt.signal_name} at window {eval_idx}")
                if agreed_stop is not None:
                    preempted = True
                    break

        if fleet_coord is not None and not preempted:
            # A SIGTERM during the last window has no later gather to carry
            # its flag: one bounded store vote at a point every rank reaches.
            if preempt.stop_requested():
                fleet_coord.request_stop(
                    fleet.FLAG_PREEMPT, note=f"{preempt.signal_name} during the final window")
            final_decision = fleet_coord.agree_at_window(num_evaluation)
            if final_decision.stop:
                if agreed_stop is None:
                    agreed_stop = final_decision
                preempted = True

        if preempted:
            if preempt.stop_requested():
                preempt.acknowledge(dispatched_t)
            elif agreed_stop is not None:
                # Stopping on a peer's flag: the same drain and save, at the
                # same window.
                log.warning("[fleet] %s — draining and checkpointing at step %d in "
                            "lockstep with the fleet", agreed_stop.describe(), dispatched_t)
            if checkpointer is not None:
                if last_save_t != dispatched_t:
                    # The cadence did not cover the last window: an emergency
                    # save of the live state.
                    start = time.perf_counter()
                    with span("emergency_ckpt", step=dispatched_t):
                        checkpointer.save(dispatched_t, learner_state, final_return, force=True)
                    phases["ckpt_s"] += time.perf_counter() - start
                log.warning("[preemption] emergency state secured at step %d — exiting "
                            "cleanly; resume with logger.checkpointing.load_model=true",
                            dispatched_t)
            else:
                log.warning("[preemption] checkpointing disabled "
                            "(logger.checkpointing.save_model=false): stopping cleanly at step "
                            "%d WITHOUT saving state", dispatched_t)
        elif bool(config.arch.get("absolute_metric", True)):
            abs_metrics = fetch_global(absolute_evaluator(best_params, eval_generator), mesh)
            logger.log(
                abs_metrics, start_step + int(config.arch.total_timesteps),
                num_evaluation, LogEvent.ABSOLUTE,
            )
            final_return = float(abs_metrics["episode_return"].mean())
    except KeyboardInterrupt:
        # The fleet monitor interrupts the main thread when a peer dies: its
        # interrupt becomes the typed error (exit 87 through the fleet's
        # excepthook); an operator's ^C with no partition re-raises as it is.
        if fleet_coord is not None and fleet_coord.partition_event.is_set():
            fleet_coord.emergency_save()  # idempotent; the monitor usually saved
            raise fleet_coord.partition_error from None
        raise
    finally:
        preempt.uninstall()
        monitor.unregister("anakin-host-loop")
        if aggregator is not None:
            aggregator.close()
            ops_server.set_aggregator(None)
        if sentinel is not None:
            # Keeps the excepthook while a corruption verdict propagates (it
            # must still become exit code 88); before the fleet's stop, so
            # the hooks unwind in reverse order.
            sentinel.deactivate()
        logger.close()

    # Close the goodput books: this run's phases, the residual to compute.
    ledger.note_phases(phases)
    LAST_RUN_STATS.clear()
    LAST_RUN_STATS.update(
        {
            "device": str(device),
            "mesh": shape,
            "num_envs_per_rank": int(config.arch.total_num_envs) // data_shards,
            "window_seconds": window_seconds,
            "steps_per_second": [steps_per_eval / w for w in window_seconds],
            # gossip_s only in runs that dispatched a round, as the JAX runner.
            "phase_breakdown": phases,
            "goodput": ledger.finalize(),
            "history": logger.history,
            "resilience": {
                "update_guard": guard_mode,
                "skipped_updates": guards.skipped_counter().value() - skipped_base,
                "preempted": preempted,
                "resume_capable": checkpointer is not None,
                "preflight": pf.enabled,
                "restored_step": start_step,
                "restore_skipped": restore_skipped,
                "elastic_restore": elastic_restore,
                "fleet": fleet_coord is not None,
                "fleet_agreed_stop": (agreed_stop.describe() if agreed_stop is not None
                                      else None),
            },
            # The rescue snapshot's host copies: how many, their bytes and
            # each window's device time (ms); None with the fleet off.
            "fleet_rescue": (None if fleet_coord is None
                             else copy.deepcopy(fleet_coord.rescue_stats)),
            "integrity": (sentinel.stats() if sentinel is not None
                          else integrity.disabled_stats()),
            "preflight": None if not pf.enabled else {
                "probe": None if probe is None else probe._asdict(),
                "first_compile_s": phases["compile_s"],
                "memory": memory,
            },
            "gossip": (
                {"num_groups": gossip_plan.num_groups, "interval": gossip_plan.interval,
                 "topology": gossip_plan.topology, "mixing_weight": gossip_plan.mixing_weight,
                 "average_opt_states": gossip_plan.average_opt_states, "rounds": gossip_rounds}
                if gossip_plan is not None else None
            ),
        }
    )
    return final_return


def run_rnn_anakin_experiment(
    config: Any, setup_fn: SetupFn, device: Union[str, torch.device] = "cuda"
) -> float:
    """The Anakin host loop for recurrent systems: `run_anakin_experiment`
    with the stateful evaluator, each episode carrying its own RNN carry from
    the cell's fresh (zero) carry. `setup_fn`'s eval_act_fn has the
    rnn_act_fn signature."""
    from stoix_tpu_torch.networks.base import ScannedRNN

    hidden_size = int(config.network.get("rnn_hidden_size", 128))
    cell_type = str(config.network.get("rnn_cell_type", "gru"))
    carry_device = resolve_device(device)

    def rnn_evaluator_setup(eval_env, act_fn, cfg):
        def init_hstate(episodes: int) -> Any:
            return ScannedRNN.initialize_carry(cell_type, hidden_size, (episodes,), carry_device)

        evaluator = get_rnn_evaluator_fn(eval_env, act_fn, cfg, init_hstate)
        absolute = get_rnn_evaluator_fn(
            eval_env, act_fn, cfg, init_hstate,
            eval_multiplier=int(cfg.arch.get("absolute_metric_multiplier", 10)),
        )
        return evaluator, absolute

    return run_anakin_experiment(config, setup_fn, device, evaluator_setup_fn=rnn_evaluator_setup)
