"""Batched tensor environments (counterpart of stoix_tpu/envs)."""

from stoix_tpu_torch.envs.core import Environment, Wrapper
from stoix_tpu_torch.envs.registry import make, make_single
from stoix_tpu_torch.envs.types import (
    Observation,
    StepType,
    TimeStep,
    get_final_step_metrics,
)

__all__ = [
    "Environment",
    "Observation",
    "StepType",
    "TimeStep",
    "Wrapper",
    "get_final_step_metrics",
    "make",
    "make_single",
]
