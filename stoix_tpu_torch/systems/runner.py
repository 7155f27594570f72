"""Shared Anakin host loop (counterpart of
stoix_tpu/systems/runner.py::run_anakin_experiment, synchronous only).

Per eval window: run `num_updates_per_eval` learner updates, wait for the
device, evaluate the new actor params, log, and keep the best params; after
the last window, the absolute metric evaluates the best params over
`absolute_metric_multiplier` times as many episodes.

`arch.pipelined_loop` is read and this synchronous loop serves both values:
the JAX package pins the trajectory bit-identical either way, and PyTorch
gains nothing from a one-window-deep dispatch that its eager launches do not
already overlap. The JAX package's resilience, fleet, integrity, preflight,
checkpoint and telemetry layers are not ported; their knobs raise.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, NamedTuple, Union

import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.evaluator import evaluator_setup
from stoix_tpu_torch.ops import scan_kernels
from stoix_tpu_torch.systems.anakin import make_generator, make_seeds
from stoix_tpu_torch.utils.logger import LogEvent, StoixLogger
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps

# Stats of the most recent run_anakin_experiment call in this process, as
# the JAX runner's LAST_RUN_STATS: per-window wall seconds and env-steps/s,
# the logger's records, and the device the run used.
LAST_RUN_STATS: Dict[str, Any] = {}


class AnakinSetup(NamedTuple):
    """What a system's learner_setup returns to the shared runner."""

    learn: Callable[[Any], Any]  # learner_state -> ExperimentOutput
    learner_state: Any
    eval_act_fn: Callable[..., Any]  # act_fn for the evaluator
    eval_params_fn: Callable[[Any], Any]  # learner_state -> params for eval


SetupFn = Callable[[envs.Environment, Any, torch.device, int], AnakinSetup]


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


def check_ported_arch(config: Any) -> None:
    """Raise NotImplementedError, naming the key, for an arch/logger setting
    this slice of the port does not implement."""
    arch = config.arch
    unported = []
    if int(arch.get("update_batch_size", 1)) != 1:
        unported.append("arch.update_batch_size > 1")
    if int((arch.get("mesh") or {}).get("data", -1)) not in (-1, 1):
        unported.append("arch.mesh.data > 1")
    for block in ("fleet", "integrity", "preflight"):
        if (arch.get(block) or {}).get("enabled", False):
            unported.append(f"arch.{block}.enabled")
    if arch.get("fault_spec"):
        unported.append("arch.fault_spec")
    ckpt = config.logger.get("checkpointing") or {}
    for key in ("save_model", "load_model"):
        if ckpt.get(key, False):
            unported.append(f"logger.checkpointing.{key}")
    if unported:
        raise NotImplementedError("not ported: " + ", ".join(unported))


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_anakin_experiment(
    config: Any, setup_fn: SetupFn, device: Union[str, torch.device] = "cuda"
) -> float:
    """Generic Anakin experiment: returns the final eval episode-return mean."""
    device = resolve_device(device)
    check_ported_arch(config)
    scan_kernels.configure_from_config(config)
    config = check_total_timesteps(config, 1)
    config.logger.system_name = config.system.system_name

    env, eval_env = envs.make(config)
    setup_seed, eval_seed = make_seeds(int(config.arch.seed), 2)
    setup = setup_fn(env, config, device, setup_seed)
    eval_generator = make_generator(eval_seed, device)
    evaluator, absolute_evaluator = evaluator_setup(eval_env, setup.eval_act_fn, config)
    logger = StoixLogger(config)

    steps_per_eval = (
        int(config.system.rollout_length)
        * int(config.arch.total_num_envs)
        * int(config.arch.num_updates_per_eval)
    )
    learner_state = setup.learner_state
    best_params = setup.eval_params_fn(learner_state)
    best_return = -math.inf
    final_return = 0.0
    window_seconds = []
    for eval_idx in range(int(config.arch.num_evaluation)):
        start = time.perf_counter()
        output = setup.learn(learner_state)
        _synchronize(device)
        wall = time.perf_counter() - start
        window_seconds.append(wall)
        learner_state = output.learner_state
        t = (eval_idx + 1) * steps_per_eval

        # Parameters are never updated in place, so the eval params need no copy.
        eval_params = setup.eval_params_fn(learner_state)
        eval_metrics = evaluator(eval_params, eval_generator)
        logger.log(
            {**envs.get_final_step_metrics(output.episode_metrics),
             "steps_per_second": steps_per_eval / wall},
            t, eval_idx, LogEvent.ACT,
        )
        logger.log(
            {k: v.mean() for k, v in output.train_metrics.items()}, t, eval_idx, LogEvent.TRAIN
        )
        logger.log(eval_metrics, t, eval_idx, LogEvent.EVAL)
        mean_return = float(eval_metrics["episode_return"].mean())
        final_return = mean_return
        if mean_return >= best_return:
            best_return = mean_return
            best_params = eval_params

    if bool(config.arch.get("absolute_metric", True)):
        abs_metrics = absolute_evaluator(best_params, eval_generator)
        logger.log(
            abs_metrics, int(config.arch.total_timesteps), int(config.arch.num_evaluation),
            LogEvent.ABSOLUTE,
        )
        final_return = float(abs_metrics["episode_return"].mean())

    LAST_RUN_STATS.clear()
    LAST_RUN_STATS.update(
        {
            "device": str(device),
            "window_seconds": window_seconds,
            "steps_per_second": [steps_per_eval / w for w in window_seconds],
            "history": logger.history,
        }
    )
    return final_return
