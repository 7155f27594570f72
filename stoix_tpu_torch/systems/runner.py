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
built one before the evaluators are made, and the run's steps count on from
the restored step; with `save_model` each window's state is saved after its
evaluation. The update guard's host half (resilience/guards.py) reads each
window's train metrics once they are on the host. The JAX package's fleet,
integrity, preflight, compile-cache, fault-injection and telemetry layers
are not ported; their knobs raise.

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
(`groups`, the ff_ppo family): on a ("group", "data") mesh the data axis is
each group's own (`systems/anakin.py::use_mesh`), the setup returns a
GossipPlan, and its step runs every `arch.gossip.interval` windows after
the learn step and before the eval and checkpoint snapshot, as in the JAX
runner (`gossip_s` in the phases, `stoix_tpu_gossip_rounds_total`). Every
rank evaluates group 0's params, reads every group's episodes and train
metrics, and so decides alike. One group is the plain run: its plan has no
step.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.evaluator import evaluator_setup, get_rnn_evaluator_fn
from stoix_tpu_torch.observability import get_registry
from stoix_tpu_torch.ops import scan_kernels
from stoix_tpu_torch.parallel import (
    create_mesh, fetch_global, maybe_initialize_distributed, mesh_shape, process_count,
)
from stoix_tpu_torch.resilience import guards
from stoix_tpu_torch.systems import anakin
from stoix_tpu_torch.systems.anakin import make_generator, make_seeds, rank_seed
from stoix_tpu_torch.utils.checkpointing import checkpointer_from_config, loader_from_config
from stoix_tpu_torch.utils.logger import LogEvent, StoixLogger
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps

# Stats of the most recent run_anakin_experiment call in this process, as
# the JAX runner's LAST_RUN_STATS: per-window wall seconds and env-steps/s
# (of the whole run), the logger's records, the device the run used, the
# mesh and this rank's env count, and the resilience block (the guard's mode
# and skipped updates, the restored step). Every rank keeps its own.
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


def unported_arch_keys(config: Any, groups: bool = False) -> list:
    """The arch settings no runner of the port implements: a mesh axis other
    than "data" (and "group", the gossip learner groups, where the system
    takes them: `groups`) and the fleet, integrity, preflight and compile
    cache layers."""
    arch = config.arch
    taken = ("data", "group") if groups else ("data",)
    unported = [f"arch.mesh.{axis}" for axis in (arch.get("mesh") or {}) if axis not in taken]
    for block in ("fleet", "integrity", "preflight", "compile_cache"):
        if (arch.get(block) or {}).get("enabled", False):
            unported.append(f"arch.{block}.enabled")
    return unported


def check_ported_arch(config: Any, groups: bool = False) -> None:
    """Raise NotImplementedError, naming the key, for an arch/logger setting
    this slice of the port does not implement; `groups` where the system
    takes gossip learner groups (the ff_ppo family)."""
    unported = unported_arch_keys(config, groups)
    if config.arch.get("fault_spec"):
        # Anakin's faults (nan_loss, sigterm, bitflip, ...) belong to layers
        # not ported yet (ROADMAP A19); the Sebulba runners take theirs
        # (resilience/faultinject.py).
        unported.append("arch.fault_spec")
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


def run_anakin_experiment(
    config: Any,
    setup_fn: SetupFn,
    device: Union[str, torch.device] = "cuda",
    evaluator_setup_fn: Optional[EvaluatorSetupFn] = None,
    warmup_fn: Optional[Callable[[Any], Any]] = None,
    groups: bool = False,
) -> float:
    """Generic Anakin experiment: returns the final eval episode-return mean.
    A system with its own evaluator (a stateful one) passes
    `evaluator_setup_fn`; the default is the feed-forward evaluator. An
    off-policy system passes `warmup_fn` (learner_state -> learner_state, its
    buffer pre-fill), run once on the fresh state before a restore and the
    first window, as the JAX runner runs it. A system whose setup takes
    gossip learner groups (an `arch.mesh.group` axis; the ff_ppo family)
    passes `groups`; every other refuses the axis, naming it."""
    device = resolve_device(device)
    check_ported_arch(config, groups)
    guard_mode = guards.resolve_mode(config)
    scan_kernels.configure_from_config(config)
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
    with anakin.use_mesh(mesh):
        return _run(config, setup_fn, device, evaluator_setup_fn, warmup_fn, guard_mode, mesh,
                    shape, data_shards, num_groups)


def _gossip_counter():
    return get_registry().counter(GOSSIP_ROUNDS, "Cross-group parameter mixing rounds dispatched")


def _run(config, setup_fn, device, evaluator_setup_fn, warmup_fn, guard_mode, mesh, shape,
         data_shards, num_groups) -> float:
    """The host loop of `run_anakin_experiment`, with the mesh in use."""
    config = check_total_timesteps(config, data_shards)
    config.logger.system_name = config.system.system_name

    env, eval_env = envs.make(config)
    setup_seed, eval_seed = make_seeds(int(config.arch.seed), 2)
    setup = setup_fn(env, config, device, setup_seed)
    learner_state = setup.learner_state
    if warmup_fn is not None:
        learner_state = warmup_fn(learner_state)
    # Resume: the saved state restored into the freshly built one, before
    # the evaluators (the JAX runner's order).
    start_step = 0
    if config.logger.checkpointing.get("load_model", False):
        loader = loader_from_config(config, config.system.system_name)
        loader.check_version()
        load_args = config.logger.checkpointing.get("load_args") or {}
        learner_state, start_step = loader.restore(learner_state, load_args.get("timestep"))
    eval_generator = make_generator(rank_seed(eval_seed), device)
    make_evaluators = evaluator_setup_fn or evaluator_setup
    evaluator, absolute_evaluator = make_evaluators(eval_env, setup.eval_act_fn, config)
    logger = StoixLogger(config)
    checkpointer = checkpointer_from_config(config, config.system.system_name)
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
    best_params = setup.eval_params_fn(learner_state)
    best_return = -math.inf
    final_return = 0.0
    window_seconds = []
    phases = {"learn_s": 0.0, "eval_s": 0.0}
    skipped_base = guards.skipped_counter().value()
    try:
        for eval_idx in range(int(config.arch.num_evaluation)):
            start = time.perf_counter()
            output = setup.learn(learner_state)
            _synchronize(device)
            wall = time.perf_counter() - start
            window_seconds.append(wall)
            phases["learn_s"] += wall
            learner_state = output.learner_state
            if gossip_step is not None and (eval_idx + 1) % gossip_plan.interval == 0:
                # Mix before the snapshot: eval, best params and checkpoints
                # all observe the post-gossip parameters; the round index
                # seeds random_peer's edge.
                start = time.perf_counter()
                learner_state = gossip_step(learner_state, eval_idx)
                _synchronize(device)
                phases["gossip_s"] = phases.get("gossip_s", 0.0) + time.perf_counter() - start
                gossip_rounds += 1
                _gossip_counter().inc()
            t = start_step + (eval_idx + 1) * steps_per_eval

            # Parameters are never updated in place, so the eval params need no copy.
            start = time.perf_counter()
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
            # Envs along the last axis of the [updates, T, envs] episode metrics.
            episode_metrics = fetch_global(output.episode_metrics, mesh, axis=episode_axis,
                                           dim=-1)
            logger.log(
                {**envs.get_final_step_metrics(episode_metrics),
                 "steps_per_second": steps_per_eval / wall},
                t, eval_idx, LogEvent.ACT,
            )
            logger.log(
                {k: v.mean() for k, v in train_metrics.items()}, t, eval_idx,
                LogEvent.TRAIN,
            )
            logger.log(eval_metrics, t, eval_idx, LogEvent.EVAL)
            mean_return = float(eval_metrics["episode_return"].mean())
            final_return = mean_return
            if mean_return >= best_return:
                best_return = mean_return
                best_params = eval_params
            if checkpointer is not None:
                checkpointer.save(t, learner_state, mean_return)

        if bool(config.arch.get("absolute_metric", True)):
            abs_metrics = fetch_global(absolute_evaluator(best_params, eval_generator), mesh)
            logger.log(
                abs_metrics, start_step + int(config.arch.total_timesteps),
                int(config.arch.num_evaluation), LogEvent.ABSOLUTE,
            )
            final_return = float(abs_metrics["episode_return"].mean())
    finally:
        logger.close()

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
            "history": logger.history,
            "resilience": {
                "update_guard": guard_mode,
                "skipped_updates": guards.skipped_counter().value() - skipped_base,
                "resume_capable": checkpointer is not None,
                "restored_step": start_step,
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
