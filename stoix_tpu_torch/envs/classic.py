"""Classic-control environments as batched tensor code (counterpart of
stoix_tpu/envs/classic.py: CartPole, Pendulum, Acrobot, MountainCar,
MountainCarContinuous and bsuite's Catch).

All physics is elementwise float32 math on a `[num_envs, D]` state, in the
JAX package's op order, so one step of every env is a handful of tensor ops
on the device. Step limits are emitted as truncations (discount stays 1) so
GAE bootstraps through them. A continuous env takes its actions as
`[num_envs, 1]` (or `[num_envs]`) float tensors.

`reset_from_draws(draws, generator)` resets from given reset draws (a
physics env's initial physics, Catch's ball columns), so the tests can feed
the JAX package's; the port's generator stream differs from JAX's keys.
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
    put_inside,
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
            action_mask=spaces.Array((self._action_mask_dim(),), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def _action_mask_dim(self) -> int:
        return self._num_actions

    def _observe(self, state: PhysicsState) -> Observation:
        physics = state.physics
        return Observation(
            agent_view=self._agent_view(physics),
            action_mask=torch.ones(
                (physics.shape[0], self._action_mask_dim()), dtype=torch.float32,
                device=physics.device,
            ),
            step_count=state.step_count,
        )

    def _agent_view(self, physics: torch.Tensor) -> torch.Tensor:
        return physics

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[PhysicsState, TimeStep]:
        return self.reset_from_draws(self._init_physics(generator, num_envs), generator)

    def reset_from_draws(self, physics: torch.Tensor, generator: torch.Generator
                         ) -> Tuple[PhysicsState, TimeStep]:
        """Reset every env to its initial physics ([N, D] float32)."""
        device = generator.device
        physics = physics.to(device=device, dtype=torch.float32)
        num_envs = physics.shape[0]
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


def _per_env(action: torch.Tensor, num_envs: int) -> torch.Tensor:
    """One float per env from an [E, 1] (or [E]) action."""
    return action.reshape(num_envs).to(torch.float32)


class Pendulum(_ClassicEnv):
    """Pendulum-v1: continuous torque control; 200-step episodes, no
    termination. The state is [theta, thdot]; the observation
    [cos theta, sin theta, thdot]."""

    _obs_dim = 3
    _num_actions = 1

    def __init__(self, max_steps: int = 200):
        self._max_steps = int(max_steps)
        self._max_speed = 8.0
        self._max_torque = 2.0
        self._dt = 0.05
        self._g = 10.0
        self._m = 1.0
        self._l = 1.0

    def action_space(self) -> spaces.Box:
        return spaces.Box(low=-self._max_torque, high=self._max_torque, shape=(1,))

    def _action_mask_dim(self) -> int:
        return 1

    def _init_physics(self, generator: torch.Generator, num_envs: int) -> torch.Tensor:
        u = torch.rand((num_envs, 2), generator=generator, device=generator.device)
        theta = u[:, 0] * (2 * math.pi) - math.pi
        thdot = u[:, 1] * 2.0 - 1.0
        return torch.stack([theta, thdot], dim=-1)

    def _agent_view(self, physics: torch.Tensor) -> torch.Tensor:
        theta, thdot = physics.unbind(-1)
        return torch.stack([torch.cos(theta), torch.sin(theta), thdot], dim=-1)

    def _dynamics(
        self, physics: torch.Tensor, action: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        theta, thdot = physics.unbind(-1)
        u = torch.clamp(_per_env(action, physics.shape[0]), -self._max_torque, self._max_torque)
        # A floor-mod, as jnp's `%`: torch.remainder takes the divisor's sign.
        angle_norm = torch.remainder(theta + math.pi, 2 * math.pi) - math.pi
        cost = angle_norm**2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (
            3 * self._g / (2 * self._l) * torch.sin(theta) + 3.0 / (self._m * self._l**2) * u
        ) * self._dt
        newthdot = torch.clamp(newthdot, -self._max_speed, self._max_speed)
        newtheta = theta + newthdot * self._dt
        terminated = torch.zeros_like(theta, dtype=torch.bool)
        return torch.stack([newtheta, newthdot], dim=-1), -cost, terminated


class MountainCarContinuous(_ClassicEnv):
    """MountainCarContinuous-v0: continuous force, +100 at the goal, an
    action cost; 999-step episodes."""

    _obs_dim = 2
    _num_actions = 1

    def __init__(self, max_steps: int = 999):
        self._max_steps = int(max_steps)

    def action_space(self) -> spaces.Box:
        return spaces.Box(low=-1.0, high=1.0, shape=(1,))

    def _action_mask_dim(self) -> int:
        return 1

    def _init_physics(self, generator: torch.Generator, num_envs: int) -> torch.Tensor:
        u = torch.rand((num_envs,), generator=generator, device=generator.device)
        pos = u * 0.2 - 0.6
        return torch.stack([pos, torch.zeros_like(pos)], dim=-1)

    def _dynamics(
        self, physics: torch.Tensor, action: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        pos, vel = physics.unbind(-1)
        force = torch.clamp(_per_env(action, physics.shape[0]), -1.0, 1.0)
        vel = torch.clamp(vel + force * 0.0015 + torch.cos(3 * pos) * (-0.0025), -0.07, 0.07)
        pos = torch.clamp(pos + vel, -1.2, 0.6)
        vel = torch.where((pos <= -1.2) & (vel < 0), 0.0, vel)
        terminated = (pos >= 0.45) & (vel >= 0.0)
        reward = torch.where(terminated, 100.0, 0.0) - 0.1 * force**2
        return torch.stack([pos, vel], dim=-1), reward, terminated


class Acrobot(_ClassicEnv):
    """Acrobot-v1: swing up a two-link pendulum; -1 a step until the goal.
    The state is [theta1, theta2, dtheta1, dtheta2]; one RK4 step a control
    interval, as gym's."""

    _obs_dim = 6
    _num_actions = 3

    def __init__(self, max_steps: int = 500):
        self._max_steps = int(max_steps)
        self._dt = 0.2
        self._l1 = 1.0
        self._m1 = 1.0
        self._m2 = 1.0
        self._lc1 = 0.5
        self._lc2 = 0.5
        self._i1 = 1.0
        self._i2 = 1.0
        self._g = 9.8
        self._max_vel1 = 4 * math.pi
        self._max_vel2 = 9 * math.pi

    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(3)

    def _init_physics(self, generator: torch.Generator, num_envs: int) -> torch.Tensor:
        u = torch.rand((num_envs, 4), generator=generator, device=generator.device)
        return u * 0.2 - 0.1

    def _agent_view(self, physics: torch.Tensor) -> torch.Tensor:
        t1, t2, d1, d2 = physics.unbind(-1)
        return torch.stack([torch.cos(t1), torch.sin(t1), torch.cos(t2), torch.sin(t2), d1, d2],
                           dim=-1)

    def _dsdt(self, s: torch.Tensor, torque: torch.Tensor) -> torch.Tensor:
        t1, t2, d1, d2 = s.unbind(-1)
        m1, m2, l1, lc1, lc2, i1, i2, g = (
            self._m1, self._m2, self._l1, self._lc1, self._lc2, self._i1, self._i2, self._g,
        )
        d_1 = m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * torch.cos(t2)) + i1 + i2
        d_2 = m2 * (lc2**2 + l1 * lc2 * torch.cos(t2)) + i2
        phi2 = m2 * lc2 * g * torch.cos(t1 + t2 - math.pi / 2.0)
        phi1 = (
            -m2 * l1 * lc2 * d2**2 * torch.sin(t2)
            - 2 * m2 * l1 * lc2 * d2 * d1 * torch.sin(t2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(t1 - math.pi / 2)
            + phi2
        )
        ddtheta2 = (torque + d_2 / d_1 * phi1 - m2 * l1 * lc2 * d1**2 * torch.sin(t2) - phi2) / (
            m2 * lc2**2 + i2 - d_2**2 / d_1
        )
        ddtheta1 = -(d_2 * ddtheta2 + phi1) / d_1
        return torch.stack([d1, d2, ddtheta1, ddtheta2], dim=-1)

    def _dynamics(
        self, physics: torch.Tensor, action: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        torque = action.to(torch.float32) - 1.0
        s, dt = physics, self._dt
        k1 = self._dsdt(s, torque)
        k2 = self._dsdt(s + dt / 2 * k1, torque)
        k3 = self._dsdt(s + dt / 2 * k2, torque)
        k4 = self._dsdt(s + dt * k3, torque)
        ns = s + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        # Floor-mods, as jnp's `%`.
        t1 = torch.remainder(ns[:, 0] + math.pi, 2 * math.pi) - math.pi
        t2 = torch.remainder(ns[:, 1] + math.pi, 2 * math.pi) - math.pi
        d1 = torch.clamp(ns[:, 2], -self._max_vel1, self._max_vel1)
        d2 = torch.clamp(ns[:, 3], -self._max_vel2, self._max_vel2)
        terminated = -torch.cos(t1) - torch.cos(t2 + t1) > 1.0
        reward = torch.where(terminated, 0.0, -1.0)
        return torch.stack([t1, t2, d1, d2], dim=-1), reward, terminated


class MountainCar(_ClassicEnv):
    """MountainCar-v0 (discrete): -1 a step until the car reaches the flag."""

    _obs_dim = 2
    _num_actions = 3

    def __init__(self, max_steps: int = 200):
        self._max_steps = int(max_steps)

    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(3)

    def _init_physics(self, generator: torch.Generator, num_envs: int) -> torch.Tensor:
        u = torch.rand((num_envs,), generator=generator, device=generator.device)
        pos = u * 0.2 - 0.6
        return torch.stack([pos, torch.zeros_like(pos)], dim=-1)

    def _dynamics(
        self, physics: torch.Tensor, action: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        pos, vel = physics.unbind(-1)
        force = (action.to(torch.float32) - 1.0) * 0.001
        vel = torch.clamp(vel + force + torch.cos(3 * pos) * (-0.0025), -0.07, 0.07)
        pos = torch.clamp(pos + vel, -1.2, 0.6)
        vel = torch.where((pos <= -1.2) & (vel < 0), 0.0, vel)
        terminated = (pos >= 0.5) & (vel >= 0.0)
        return torch.stack([pos, vel], dim=-1), torch.full_like(pos, -1.0), terminated


class CatchState(NamedTuple):
    generator: torch.Generator
    ball_r: torch.Tensor  # [N] int64
    ball_c: torch.Tensor
    paddle_x: torch.Tensor
    step_count: torch.Tensor  # [N] int32


class Catch(Environment):
    """bsuite Catch: a ball falls down a rows x columns board; move the
    paddle to catch it (+1) or miss it (-1). A minimal pixel env: the
    observation is the [rows, columns, 1] board."""

    def __init__(self, rows: int = 10, columns: int = 5):
        self._rows = int(rows)
        self._columns = int(columns)

    def observation_space(self) -> Observation:
        return Observation(
            agent_view=spaces.Array((self._rows, self._columns, 1), torch.float32),
            action_mask=spaces.Array((3,), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(3)

    def _observe(self, state: CatchState) -> Observation:
        n, device = state.ball_r.shape[0], state.ball_r.device
        env = torch.arange(n, device=device)
        board = torch.zeros((n, self._rows, self._columns), dtype=torch.float32, device=device)
        # The ball falls past the board once an episode ends.
        put_inside(board, (env, state.ball_r, state.ball_c), 1.0)
        board[env, self._rows - 1, state.paddle_x] = 1.0
        return Observation(
            agent_view=board[..., None],
            action_mask=torch.ones((n, 3), dtype=torch.float32, device=device),
            step_count=state.step_count,
        )

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[CatchState, TimeStep]:
        ball_c = torch.randint(0, self._columns, (num_envs,), generator=generator,
                               device=generator.device)
        return self.reset_from_draws(ball_c, generator)

    def reset_from_draws(self, ball_c: torch.Tensor, generator: torch.Generator
                         ) -> Tuple[CatchState, TimeStep]:
        """Drop every env's ball from its column ([N] integers)."""
        ball_c = ball_c.to(device=generator.device, dtype=torch.int64)
        n = ball_c.shape[0]
        state = CatchState(generator, torch.zeros_like(ball_c), ball_c,
                           torch.full_like(ball_c, self._columns // 2),
                           torch.zeros((n,), dtype=torch.int32, device=ball_c.device))
        return state, restart(self._observe(state), n, ball_c.device)

    def step(self, state: CatchState, action: torch.Tensor) -> Tuple[CatchState, TimeStep]:
        paddle_x = torch.clamp(state.paddle_x + action.to(torch.int64) - 1, 0, self._columns - 1)
        ball_r = state.ball_r + 1
        next_state = CatchState(state.generator, ball_r, state.ball_c, paddle_x,
                                state.step_count + 1)
        obs = self._observe(next_state)
        done = ball_r >= self._rows - 1
        reward = torch.where(done, torch.where(paddle_x == state.ball_c, 1.0, -1.0), 0.0)
        return next_state, select_step(done, termination(reward, obs), transition(reward, obs))
