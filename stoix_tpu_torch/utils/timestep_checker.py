"""Budget arithmetic: reconcile total_timesteps <-> num_updates and derive
per-shard env counts (counterpart of stoix_tpu/utils/timestep_checker.py).

Anakin accounting (per update):
    steps_per_update = rollout_length * total_num_envs
    num_updates      = total_timesteps // steps_per_update

`total_num_envs` is GLOBAL; each data shard runs
total_num_envs / (num_data_shards * update_batch_size) envs.
"""

from __future__ import annotations

from typing import Any

import logging


def _log() -> logging.Logger:
    return logging.getLogger("stoix_tpu_torch.timestep_check")


def check_total_timesteps(config: Any, num_data_shards: int) -> Any:
    arch = config.arch
    system = config.system

    update_batch_size = int(arch.get("update_batch_size", 1))
    total_num_envs = int(arch.total_num_envs)
    divisor = num_data_shards * update_batch_size
    if total_num_envs % divisor != 0:
        raise ValueError(
            f"arch.total_num_envs ({total_num_envs}) must be divisible by "
            f"num_data_shards * update_batch_size ({num_data_shards} * {update_batch_size})"
        )
    arch.num_envs_per_shard = total_num_envs // divisor

    steps_per_update = int(system.rollout_length) * total_num_envs
    if arch.get("num_updates") in (None, "~"):
        assert arch.get("total_timesteps") is not None, (
            "Set either arch.total_timesteps or arch.num_updates"
        )
        arch.num_updates = max(1, int(float(arch.total_timesteps)) // steps_per_update)
    requested = arch.get("total_timesteps")
    arch.total_timesteps = int(arch.num_updates) * steps_per_update
    if requested is not None and int(float(requested)) != arch.total_timesteps:
        _log().info(
            f"[timestep-check] total_timesteps adjusted {int(float(requested))} -> "
            f"{arch.total_timesteps} (num_updates={arch.num_updates}, "
            f"steps/update={steps_per_update})"
        )

    num_evaluation = max(1, int(arch.get("num_evaluation", 1)))
    num_updates = int(arch.num_updates)
    if num_updates % num_evaluation != 0:
        if num_updates >= num_evaluation:
            # Keep the REQUESTED eval cadence and trim num_updates down to a
            # multiple of it (costs < one eval period of budget), as the JAX
            # package does, so both count the same timesteps.
            trimmed = (num_updates // num_evaluation) * num_evaluation
            _log().info(
                f"[timestep-check] num_updates adjusted {num_updates} -> "
                f"{trimmed} (multiple of num_evaluation={num_evaluation}; "
                f"total_timesteps {arch.total_timesteps} -> "
                f"{trimmed * steps_per_update})"
            )
            num_updates = trimmed
            arch.num_updates = trimmed
            arch.total_timesteps = trimmed * steps_per_update
        else:
            requested_evals = num_evaluation
            num_evaluation = num_updates  # one eval per update
            _log().info(
                f"[timestep-check] num_evaluation adjusted {requested_evals} "
                f"-> {num_evaluation} (run has only {num_updates} updates)"
            )
    arch.num_evaluation = num_evaluation
    arch.num_updates_per_eval = int(arch.num_updates) // num_evaluation
    return config
