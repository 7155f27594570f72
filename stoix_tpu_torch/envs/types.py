"""Core environment types: StepType, TimeStep, Observation (counterpart of
stoix_tpu/envs/types.py).

Every field is a tensor with a leading env axis: the port's envs are batched
(one tensor op steps every env), so a TimeStep's `reward` is `[num_envs]` and
its observation's `agent_view` is `[num_envs, ...]`.

Truncation semantics:
  - termination: step_type == LAST and discount == 0.0
  - truncation:  step_type == LAST and discount == 1.0  (bootstrapping continues)
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


class StepType:
    """Integer step-type codes, stored as int8 tensors inside TimeStep."""

    FIRST = 0
    MID = 1
    LAST = 2


class TimeStep(NamedTuple):
    """One transition's worth of env output for every env of the batch.

    extras is a flat dict; well-known keys:
      "next_obs"          — true next observation before any auto-reset (bootstrap).
      "episode_metrics"   — dict(episode_return, episode_length, is_terminal_step).
      "truncation"        — bool, LAST due to step limit (discount stays 1).
    """

    step_type: torch.Tensor  # int8 [N]
    reward: torch.Tensor  # float32 [N]
    discount: torch.Tensor  # float32 [N]
    observation: Any
    extras: Dict[str, Any]

    def last(self) -> torch.Tensor:
        return self.step_type == StepType.LAST


def _step(
    code: int, reward: torch.Tensor, discount: float, observation: Any,
    extras: Optional[Dict[str, Any]],
) -> TimeStep:
    reward = reward.to(torch.float32)
    return TimeStep(
        step_type=torch.full(reward.shape, code, dtype=torch.int8, device=reward.device),
        reward=reward,
        discount=torch.full(reward.shape, discount, dtype=torch.float32, device=reward.device),
        observation=observation,
        extras=extras if extras is not None else {},
    )


def restart(
    observation: Any, num_envs: int, device: torch.device,
    extras: Optional[Dict[str, Any]] = None,
) -> TimeStep:
    reward = torch.zeros((num_envs,), dtype=torch.float32, device=device)
    return _step(StepType.FIRST, reward, 1.0, observation, extras)


def transition(
    reward: torch.Tensor, observation: Any, extras: Optional[Dict[str, Any]] = None
) -> TimeStep:
    return _step(StepType.MID, reward, 1.0, observation, extras)


def termination(
    reward: torch.Tensor, observation: Any, extras: Optional[Dict[str, Any]] = None
) -> TimeStep:
    return _step(StepType.LAST, reward, 0.0, observation, extras)


def truncation(
    reward: torch.Tensor, observation: Any, extras: Optional[Dict[str, Any]] = None
) -> TimeStep:
    return _step(StepType.LAST, reward, 1.0, observation, extras)


def _bcast(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    extra = like.dim() - flag.dim()
    return flag.reshape(flag.shape + (1,) * extra) if extra > 0 else flag


def tree_select(flag: torch.Tensor, a: Any, b: Any) -> Any:
    """Per-env select over matching trees of tensors: `a` where `flag`, else `b`.

    NamedTuples, dicts, lists and tuples recurse; a leaf that is not a tensor
    (an env state's `torch.Generator`) is taken from `b`."""
    if isinstance(a, torch.Tensor):
        return torch.where(_bcast(flag, a), a, b)
    if hasattr(a, "_fields"):
        return type(a)(*(tree_select(flag, x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return {k: tree_select(flag, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(tree_select(flag, x, y) for x, y in zip(a, b))
    return b


def put_inside(board: torch.Tensor, index: Tuple[torch.Tensor, ...], value: Any) -> None:
    """`board[index] = value` in place, with the writes whose index is out
    of range dropped, as XLA drops them from a scatter (`.at[].set`): an env
    stepped past its end (the evaluator steps finished envs and discards
    the result) may index past the board."""
    inside = True
    clamped = []
    for axis, idx in enumerate(index):
        if isinstance(idx, torch.Tensor):  # an int index is the caller's constant
            size = board.shape[axis]
            inside = inside & (idx >= 0) & (idx < size)
            idx = torch.clamp(idx, 0, size - 1)
        clamped.append(idx)
    clamped = tuple(clamped)
    board[clamped] = torch.where(inside, value, board[clamped])


def select_step(done: torch.Tensor, terminal_ts: TimeStep, mid_ts: TimeStep) -> TimeStep:
    """Per-env select between terminal and mid timesteps."""
    return tree_select(done, terminal_ts, mid_ts)


class Observation(NamedTuple):
    """Canonical structured observation.

    agent_view:  the raw observable features: [N, obs_dim] vectors, or
                 images [N, H, W, C] (NHWC, as the JAX package's) for the
                 grid and pixel envs.
    action_mask: legal-action mask [N, num_actions] (all-ones when unmasked).
    step_count:  steps elapsed in the current episode [N].
    """

    agent_view: torch.Tensor
    action_mask: torch.Tensor
    step_count: torch.Tensor


def get_final_step_metrics(metrics: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Filter episode metrics to completed episodes only, as 1-D host arrays."""
    host = {k: _to_numpy(v).reshape(-1) for k, v in metrics.items()}
    is_final = host["is_terminal_step"].astype(bool)
    return {k: v[is_final] for k, v in host.items() if k != "is_terminal_step"}


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
