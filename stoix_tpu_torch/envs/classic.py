"""Classic-control environments as batched tensor code (counterpart of
stoix_tpu/envs/classic.py, the CartPole subset).

All physics is elementwise float32 math on a `[num_envs, 4]` state, in the
JAX package's op order, so one step of every env is a handful of tensor ops
on the device. Step limits are emitted as truncations (discount stays 1) so
GAE bootstraps through them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from stoix_tpu_torch.envs import spaces
from stoix_tpu_torch.envs.core import Environment
from stoix_tpu_torch.envs.types import (
    Observation,
    TimeStep,
    restart,
    select_step,
    termination,
    transition,
    truncation,
)


class PhysicsState(NamedTuple):
    generator: torch.Generator
    physics: torch.Tensor  # [N, obs_dim] float32
    step_count: torch.Tensor  # [N] int32


class _ClassicEnv(Environment):
    """Shared plumbing: PhysicsState, Observation assembly, truncation."""

    _obs_dim: int
    _num_actions: int
    _max_steps: int

    def observation_space(self) -> Observation:
        return Observation(
            agent_view=spaces.Array((self._obs_dim,), torch.float32),
            action_mask=spaces.Array((self._num_actions,), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def _observe(self, state: PhysicsState) -> Observation:
        physics = state.physics
        return Observation(
            agent_view=physics,
            action_mask=torch.ones(
                (physics.shape[0], self._num_actions), dtype=torch.float32, device=physics.device
            ),
            step_count=state.step_count,
        )

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[PhysicsState, TimeStep]:
        device = generator.device
        physics = self._init_physics(generator, num_envs)
        state = PhysicsState(
            generator, physics, torch.zeros((num_envs,), dtype=torch.int32, device=device)
        )
        ts = restart(self._observe(state), num_envs, device)
        # Reset and step TimeSteps carry the same extras keys.
        ts.extras["truncation"] = torch.zeros((num_envs,), dtype=torch.bool, device=device)
        return state, ts

    def step(self, state: PhysicsState, action: torch.Tensor) -> Tuple[PhysicsState, TimeStep]:
        physics, reward, terminated = self._dynamics(state.physics, action)
        next_state = PhysicsState(state.generator, physics, state.step_count + 1)
        obs = self._observe(next_state)
        truncated = (next_state.step_count >= self._max_steps) & ~terminated
        ts = select_step(
            terminated,
            termination(reward, obs),
            select_step(truncated, truncation(reward, obs), transition(reward, obs)),
        )
        ts.extras["truncation"] = truncated
        return next_state, ts

    def _init_physics(self, generator: torch.Generator, num_envs: int) -> torch.Tensor:
        raise NotImplementedError

    def _dynamics(
        self, physics: torch.Tensor, action: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (next_physics, reward, terminated)."""
        raise NotImplementedError


class CartPole(_ClassicEnv):
    """CartPole-v1: balance a pole on a cart; +1 per step, 500-step limit."""

    _obs_dim = 4
    _num_actions = 2

    def __init__(self, max_steps: int = 500):
        self._max_steps = int(max_steps)
        self._gravity = 9.8
        self._masscart = 1.0
        self._masspole = 0.1
        self._length = 0.5
        self._force_mag = 10.0
        self._tau = 0.02
        self._theta_threshold = 12 * 2 * math.pi / 360
        self._x_threshold = 2.4

    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(2)

    def _init_physics(self, generator: torch.Generator, num_envs: int) -> torch.Tensor:
        u = torch.rand((num_envs, 4), generator=generator, device=generator.device)
        return u * 0.1 - 0.05

    def _dynamics(
        self, physics: torch.Tensor, action: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x, x_dot, theta, theta_dot = physics.unbind(-1)
        force = torch.where(action == 1, self._force_mag, -self._force_mag).to(physics.dtype)
        costheta, sintheta = torch.cos(theta), torch.sin(theta)
        total_mass = self._masscart + self._masspole
        polemass_length = self._masspole * self._length
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self._gravity * sintheta - costheta * temp) / (
            self._length * (4.0 / 3.0 - self._masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self._tau * x_dot
        x_dot = x_dot + self._tau * xacc
        theta = theta + self._tau * theta_dot
        theta_dot = theta_dot + self._tau * thetaacc
        next_physics = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        terminated = (x.abs() > self._x_threshold) | (theta.abs() > self._theta_threshold)
        return next_physics, torch.ones_like(x), terminated
