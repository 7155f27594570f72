"""Shared type vocabulary (counterpart of stoix_tpu/base_types.py, the subset
the Anakin PPO, recurrent PPO and value-based slices use, recurrent
off-policy replay included), as NamedTuples of tensors. Where
the JAX package's learner states carry a PRNG `key`, the port's carry the
`generator` (a torch.Generator, or a tuple of one a replica).

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


class OnlineAndTarget(NamedTuple):
    online: Parameters
    target: Parameters


class OnPolicyLearnerState(NamedTuple):
    params: Any
    opt_states: Any
    generator: Any
    env_state: Any
    timestep: TimeStep


class RNNLearnerState(NamedTuple):
    params: Any
    opt_states: Any
    generator: Any
    env_state: Any
    timestep: TimeStep
    done: torch.Tensor  # [E] the last step's termination, the RNN's next reset
    truncated: torch.Tensor  # [E] the last step's truncation, likewise
    hstates: Any  # (actor, critic) carries after the last step, each [E, H] (LSTM: a pair)
    obs_stats: Any = None  # observation running statistics (rec_ppo)


class OffPolicyLearnerState(NamedTuple):
    params: Any
    opt_states: Any
    buffer_state: Any  # an ItemBufferState, or a tuple of one a replica
    generator: Any
    env_state: Any
    timestep: TimeStep


class RNNOffPolicyLearnerState(NamedTuple):
    """The off-policy learner state of a recurrent system (rec_r2d2)."""

    params: Any
    opt_states: Any
    buffer_state: Any  # a PrioritisedTrajectoryBufferState, or a tuple of one a replica
    generator: Any
    env_state: Any
    timestep: TimeStep
    done: torch.Tensor  # [E] the last step's termination, the RNN's next reset
    truncated: torch.Tensor  # [E] the last step's truncation, likewise
    hstates: Any  # the Q-network's carry after the last step, [E, H] (LSTM: a pair)


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


class Transition(NamedTuple):
    """Generic off-policy transition (DQN family)."""

    obs: Any
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    next_obs: Any
    info: Dict[str, Any]


class ExperimentOutput(NamedTuple):
    learner_state: Any
    episode_metrics: Metrics
    train_metrics: Metrics
