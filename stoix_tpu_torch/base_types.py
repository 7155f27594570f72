"""Shared type vocabulary (counterpart of stoix_tpu/base_types.py, the subset
the Anakin PPO slice uses), as NamedTuples of tensors.

Parameters are plain `{name: tensor}` dicts, as `nn.Module.named_parameters`
gives them, applied with `torch.func.functional_call`.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from stoix_tpu_torch.envs.types import Observation, TimeStep  # noqa: F401  (re-export)

Parameters = Dict[str, torch.Tensor]
OptStates = Any
Metrics = Dict[str, torch.Tensor]


class ActorCriticParams(NamedTuple):
    actor_params: Parameters
    critic_params: Parameters


class ActorCriticOptStates(NamedTuple):
    actor_opt_state: OptStates
    critic_opt_state: OptStates


class PPOTransition(NamedTuple):
    done: torch.Tensor
    truncated: torch.Tensor
    action: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    log_prob: torch.Tensor
    obs: Any
    next_obs: Any
    info: Dict[str, Any]


class ExperimentOutput(NamedTuple):
    learner_state: Any
    episode_metrics: Metrics
    train_metrics: Metrics
