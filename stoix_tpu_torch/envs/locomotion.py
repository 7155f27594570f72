"""Locomotion environments on the batched rigid-body engine (counterpart of
stoix_tpu/envs/locomotion.py).

  - `Ant` — 9-body quadruped (torso + 4 two-link legs), 8 actuated hinges,
    27-dim observation, healthy-band termination, `max_steps` truncation.
  - `Hopper` / `Walker2d` / `HalfCheetah` — the planar morphologies (motion in
    the x-z plane, hinges about +y, observations 11 / 17 / 17).

Geometry, gains, rewards and termination are the JAX package's, built from
the same numpy arithmetic, so the systems' float32 arrays are equal. Every
env of a batch steps at once: the state's bodies are [E, nb, ...] tensors on
the generator's device, and one control step is `rigid_body.step`'s fixed
sequence of tensor ops (16 substeps), with no host read.

`reset_from_draws(draws, generator)` resets from given reset draws [E, 2,
nb, 3]: the position noise's uniforms on [-1, 1), then the velocities (the
reset noise's scale times standard normals), so the tests can feed the JAX
package's (its velocities read from its reset state: XLA folds the scale
into its normal sampler, so no standard normal rebuilt outside it rounds to
the same product); the port's generator stream differs from JAX's keys.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from stoix_tpu_torch.envs import spaces
from stoix_tpu_torch.envs.core import Environment
from stoix_tpu_torch.envs.rigid_body import (
    RigidBodyState,
    RigidBodySystem,
    dot,
    fma,
    joint_angles,
    joint_velocities,
    make_system,
    rest_state,
    step,
)
from stoix_tpu_torch.envs.types import (
    Observation,
    TimeStep,
    restart,
    select_step,
    termination,
    transition,
    truncation,
)


def _build_ant() -> Tuple[RigidBodySystem, np.ndarray]:
    """9-body quadruped: torso sphere + 4 (upper, lower) leg links. Body
    frames coincide with the world frame in the rest pose."""
    z0 = 0.77  # rest torso height; lower-leg tips then rest at z ~ 0.08
    torso_r = 0.25
    upper_len = 0.4
    lower_len = 0.8
    leg_angles = [np.pi / 4, 3 * np.pi / 4, 5 * np.pi / 4, 7 * np.pi / 4]

    pos = [np.array([0.0, 0.0, z0])]
    mass = [3.0]
    inertia = [np.full(3, 0.075)]  # solid sphere: 2/5 m r^2
    joint_parent, joint_child = [], []
    anchor_p, anchor_c, axis_p, limit, gear = [], [], [], [], []
    sphere_body = [0]
    sphere_offset = [np.zeros(3)]
    sphere_radius = [torso_r]

    for phi in leg_angles:
        d = np.array([np.cos(phi), np.sin(phi), 0.0])  # outward
        t = np.array([-np.sin(phi), np.cos(phi), 0.0])  # tangent
        # Lower legs point outward-down at 60 degrees below horizontal.
        e = 0.5 * d - np.array([0.0, 0.0, np.sqrt(3.0) / 2.0])

        hip_world = pos[0] + torso_r * d
        knee_world = hip_world + upper_len * d
        tip_world = knee_world + lower_len * e

        upper_idx = len(pos)
        pos.append(hip_world + 0.5 * upper_len * d)  # upper-leg COM
        mass.append(0.5)
        inertia.append(np.full(3, 0.02))  # rod ~0.007, padded for stability
        joint_parent.append(0)
        joint_child.append(upper_idx)
        anchor_p.append(hip_world - pos[0])
        anchor_c.append(hip_world - pos[upper_idx])
        axis_p.append(np.array([0.0, 0.0, 1.0]))  # hip swings horizontally
        limit.append(np.array([-0.6, 0.6]))
        gear.append(15.0)

        lower_idx = len(pos)
        pos.append(knee_world + 0.5 * lower_len * e)  # lower-leg COM
        mass.append(0.5)
        inertia.append(np.full(3, 0.04))  # rod ~0.027, padded
        joint_parent.append(upper_idx)
        joint_child.append(lower_idx)
        anchor_p.append(knee_world - pos[upper_idx])
        anchor_c.append(knee_world - pos[lower_idx])
        axis_p.append(t)  # ankle swings vertically
        limit.append(np.array([-0.35, 0.35]))
        gear.append(15.0)

        sphere_body += [upper_idx, lower_idx]
        sphere_offset += [knee_world - pos[upper_idx], tip_world - pos[lower_idx]]
        sphere_radius += [0.06, 0.08]

    f32 = lambda x: np.asarray(np.asarray(x), np.float32)  # noqa: E731
    sys = make_system(
        mass=f32(mass), inertia=f32(inertia), static=np.zeros((len(mass),), np.float32),
        joint_parent=joint_parent, joint_child=joint_child, anchor_p=f32(anchor_p),
        anchor_c=f32(anchor_c), axis_p=f32(axis_p), limit=f32(limit), gear=f32(gear),
        sphere_body=sphere_body, sphere_offset=f32(sphere_offset),
        sphere_radius=f32(sphere_radius),
    )
    return sys, np.asarray(pos, np.float32)


class LocoState(NamedTuple):
    generator: torch.Generator
    body: RigidBodyState
    step_count: torch.Tensor  # [E] int32


class _Locomotion(Environment):
    """Shared run-in-+x scaffolding: reward = forward velocity + healthy
    bonus - ctrl_cost_weight |a|^2; episodes truncate at `max_steps`.
    Subclasses set `_sys`, `_rest_pos`, `_obs_dim` and supply `_observe`
    and `_healthy` (None: no healthy-band termination)."""

    _healthy_reward: float = 1.0
    _ctrl_cost_weight: float = 0.1
    _sys: RigidBodySystem
    _rest_pos: np.ndarray
    _obs_dim: int
    _max_steps: int
    _reset_noise: float

    def _on(self, device: torch.device) -> Tuple[RigidBodySystem, torch.Tensor, torch.Tensor]:
        """The system, the rest pose and the reset noise's per-axis scale
        (reset_noise x mask, a float32 constant as XLA folds it) on
        `device`, moved there once."""
        cache: Dict[str, tuple] = self.__dict__.setdefault("_devices", {})
        key = str(device)
        if key not in cache:
            noise = np.float32(self._reset_noise) * np.asarray(self._noise_mask(), np.float32)
            cache[key] = (self._sys.to(device), torch.as_tensor(self._rest_pos, device=device),
                          torch.as_tensor(noise, device=device))
        return cache[key]

    def _system(self, device: torch.device) -> RigidBodySystem:
        return self._on(device)[0]

    def _noise_mask(self) -> Tuple[float, float, float]:
        """Per-axis reset-noise mask (planar robots zero the y column)."""
        return (1.0, 0.0, 1.0) if self._sys.planar else (1.0, 1.0, 1.0)

    def _healthy(self, sys: RigidBodySystem, body: RigidBodyState) -> Optional[torch.Tensor]:
        raise NotImplementedError

    def _observe(self, sys: RigidBodySystem, state: LocoState) -> Observation:
        raise NotImplementedError

    @property
    def _nj(self) -> int:
        return int(self._sys.num_joints)

    def observation_space(self) -> Observation:
        return Observation(
            agent_view=spaces.Array((self._obs_dim,), torch.float32),
            action_mask=spaces.Array((self._nj,), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def action_space(self) -> spaces.Box:
        return spaces.Box(low=-1.0, high=1.0, shape=(self._nj,))

    def _mask(self, view: torch.Tensor) -> torch.Tensor:
        return torch.ones((view.shape[0], self._nj), dtype=torch.float32, device=view.device)

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[LocoState, TimeStep]:
        nb, device = self._sys.num_bodies, generator.device
        uniform = torch.rand((num_envs, nb, 3), generator=generator, device=device) * 2.0 - 1.0
        normal = torch.randn((num_envs, nb, 3), generator=generator, device=device)
        velocity = self._on(device)[2] * normal
        return self.reset_from_draws(torch.stack([uniform, velocity], dim=1), generator)

    def reset_from_draws(self, draws: torch.Tensor, generator: torch.Generator
                         ) -> Tuple[LocoState, TimeStep]:
        """Reset every env from its draws [E, 2, nb, 3]: the rest pose plus
        `reset_noise` x mask x uniform on the positions, and the velocities."""
        device = generator.device
        draws = draws.to(device=device, dtype=torch.float32)
        num_envs = draws.shape[0]
        sys, rest_pos, noise_scale = self._on(device)
        body = rest_state(sys, rest_pos, num_envs)
        body = body._replace(pos=fma(draws[:, 0], noise_scale, body.pos), vel=draws[:, 1].clone())
        state = LocoState(generator, body,
                          torch.zeros((num_envs,), dtype=torch.int32, device=device))
        ts = restart(self._observe(sys, state), num_envs, device)
        ts.extras["truncation"] = torch.zeros((num_envs,), dtype=torch.bool, device=device)
        return state, ts

    def step(self, state: LocoState, action: torch.Tensor) -> Tuple[LocoState, TimeStep]:
        num_envs = state.step_count.shape[0]
        sys = self._system(state.step_count.device)
        action = torch.clamp(action.reshape(num_envs, self._nj).to(torch.float32), -1.0, 1.0)
        body = step(sys, state.body, action)
        next_state = LocoState(state.generator, body, state.step_count + 1)

        finite = torch.stack([torch.isfinite(leaf).flatten(1).all(dim=1) for leaf in body]
                             ).all(dim=0)
        healthy = self._healthy(sys, body)
        if healthy is None:
            terminated = ~finite
        else:
            # The INCOMING state is checked too: one already outside the band
            # terminates even where a control step would bounce it back in.
            healthy = healthy & self._healthy(sys, state.body)
            terminated = ~healthy | ~finite

        reward = fma(-self._ctrl_cost_weight, dot(action, action),
                     body.vel[:, 0, 0] + self._healthy_reward)
        reward = torch.where(finite, reward, torch.zeros_like(reward))

        obs = self._observe(sys, next_state)
        # Non-finite physics must not reach the learner (terminated anyway).
        obs = obs._replace(agent_view=torch.nan_to_num(obs.agent_view))
        truncated = (next_state.step_count >= self._max_steps) & ~terminated
        ts = select_step(
            terminated,
            termination(reward, obs),
            select_step(truncated, truncation(reward, obs), transition(reward, obs)),
        )
        ts.extras["truncation"] = truncated
        return next_state, ts


class Ant(_Locomotion):
    """Quadruped locomotion: run in +x; terminates when the torso leaves its
    healthy height band."""

    _obs_dim = 27

    def __init__(self, max_steps: int = 1000, healthy_z: Tuple[float, float] = (0.35, 1.2),
                 ctrl_cost_weight: float = 0.05, healthy_reward: float = 1.0,
                 reset_noise: float = 0.05):
        self._max_steps = int(max_steps)
        self._healthy_z = (float(healthy_z[0]), float(healthy_z[1]))
        self._ctrl_cost_weight = float(ctrl_cost_weight)
        self._healthy_reward = float(healthy_reward)
        self._reset_noise = float(reset_noise)
        self._sys, self._rest_pos = _build_ant()

    def _healthy(self, sys: RigidBodySystem, body: RigidBodyState) -> torch.Tensor:
        torso_z = body.pos[:, 0, 2]
        return (torso_z > self._healthy_z[0]) & (torso_z < self._healthy_z[1])

    def _observe(self, sys: RigidBodySystem, state: LocoState) -> Observation:
        body = state.body
        view = torch.cat([
            body.pos[:, 0, 2:3],  # torso height (x/y excluded: translation-invariant)
            body.quat[:, 0],  # torso orientation
            body.vel[:, 0],  # torso linear velocity
            body.ang[:, 0],  # torso angular velocity
            joint_angles(sys, body),  # 8
            joint_velocities(sys, body),  # 8
        ], dim=-1)
        return Observation(view, self._mask(view), state.step_count)


# --- planar morphologies (hopper / walker2d / halfcheetah) -------------------


class _PlanarBuilder:
    """Accumulates bodies/joints/spheres for a planar chain robot: geometry in
    the x-z plane, every hinge axis +y, body frames the world frame at rest."""

    def __init__(self) -> None:
        self.pos: list = []
        self.mass: list = []
        self.inertia: list = []
        self.joint_parent: list = []
        self.joint_child: list = []
        self.anchor_p: list = []
        self.anchor_c: list = []
        self.limit: list = []
        self.gear: list = []
        self.sphere_body: list = []
        self.sphere_offset: list = []
        self.sphere_radius: list = []

    def body(self, com, mass: float, inertia: float) -> int:
        idx = len(self.pos)
        self.pos.append(np.asarray(com, np.float64))
        self.mass.append(mass)
        self.inertia.append(np.full(3, inertia))
        return idx

    def hinge(self, parent: int, child: int, anchor_world, limit, gear: float) -> None:
        anchor_world = np.asarray(anchor_world, np.float64)
        self.joint_parent.append(parent)
        self.joint_child.append(child)
        self.anchor_p.append(anchor_world - self.pos[parent])
        self.anchor_c.append(anchor_world - self.pos[child])
        self.limit.append(np.asarray(limit, np.float64))
        self.gear.append(gear)

    def sphere(self, body: int, centre_world, radius: float) -> None:
        self.sphere_body.append(body)
        self.sphere_offset.append(np.asarray(centre_world, np.float64) - self.pos[body])
        self.sphere_radius.append(radius)

    def build(self, **scalars) -> Tuple[RigidBodySystem, np.ndarray]:
        f32 = lambda x: np.asarray(np.asarray(x), np.float32)  # noqa: E731
        nj = len(self.joint_parent)
        sys = make_system(
            mass=f32(self.mass), inertia=f32(self.inertia),
            static=np.zeros((len(self.mass),), np.float32), joint_parent=self.joint_parent,
            joint_child=self.joint_child, anchor_p=f32(self.anchor_p),
            anchor_c=f32(self.anchor_c), axis_p=f32(np.tile([0.0, 1.0, 0.0], (nj, 1))),
            limit=f32(self.limit), gear=f32(self.gear), sphere_body=self.sphere_body,
            sphere_offset=f32(self.sphere_offset), sphere_radius=f32(self.sphere_radius),
            planar=True, **scalars,
        )
        return sys, np.asarray(self.pos, np.float32)


def _leg(b: _PlanarBuilder, torso: int, hip_world, gear: float = 30.0) -> None:
    """One (thigh, leg, foot) planar leg hanging from `hip_world`."""
    hip = np.asarray(hip_world, np.float64)
    knee = hip - np.asarray([0.0, 0.0, 0.45])
    ankle = knee - np.asarray([0.0, 0.0, 0.5])
    heel = ankle + np.asarray([-0.13, 0.0, 0.0])
    toe = ankle + np.asarray([0.26, 0.0, 0.0])

    thigh = b.body(com=(hip + knee) / 2.0, mass=0.8, inertia=0.03)
    b.hinge(torso, thigh, hip, limit=(-0.9, 0.9), gear=gear)
    leg = b.body(com=(knee + ankle) / 2.0, mass=0.6, inertia=0.03)
    b.hinge(thigh, leg, knee, limit=(-1.2, 1.2), gear=gear)
    foot = b.body(com=(heel + toe) / 2.0, mass=0.4, inertia=0.02)
    b.hinge(leg, foot, ankle, limit=(-0.6, 0.6), gear=gear / 2.0)
    b.sphere(foot, heel, 0.08)
    b.sphere(foot, toe, 0.08)


# Passive hinge-axis hold PD for the legged planar morphologies: it holds
# walker2d (two legs) standing under zero action, while hopper (one leg)
# still collapses.
_LEG_HOLD_KP = 35.0
_LEG_HOLD_KD = 1.0


def _build_hopper() -> Tuple[RigidBodySystem, np.ndarray]:
    """4-body monoped: torso rod (z 1.05-1.45) on one (thigh, leg, foot)."""
    b = _PlanarBuilder()
    torso = b.body(com=(0.0, 0.0, 1.25), mass=3.0, inertia=0.08)
    b.sphere(torso, (0.0, 0.0, 1.45), 0.08)  # crown contact for falls
    _leg(b, torso, hip_world=(0.0, 0.0, 1.05))
    return b.build(hold_kp=_LEG_HOLD_KP, hold_kd=_LEG_HOLD_KD)


def _build_walker2d() -> Tuple[RigidBodySystem, np.ndarray]:
    """7-body biped: the hopper torso with two legs on the same hip point."""
    b = _PlanarBuilder()
    torso = b.body(com=(0.0, 0.0, 1.25), mass=3.0, inertia=0.08)
    b.sphere(torso, (0.0, 0.0, 1.45), 0.08)
    _leg(b, torso, hip_world=(0.0, 0.0, 1.05))
    _leg(b, torso, hip_world=(0.0, 0.0, 1.05))
    return b.build(hold_kp=_LEG_HOLD_KP, hold_kd=_LEG_HOLD_KD)


def _build_halfcheetah() -> Tuple[RigidBodySystem, np.ndarray]:
    """7-body planar runner: horizontal torso rod with a (thigh, shin, foot)
    leg at each end. No healthy band."""
    b = _PlanarBuilder()
    z0 = 0.6
    torso = b.body(com=(0.0, 0.0, z0), mass=3.0, inertia=0.3)
    b.sphere(torso, (-0.5, 0.0, z0), 0.1)
    b.sphere(torso, (0.5, 0.0, z0), 0.1)

    for hip_x, direction in ((-0.5, -1.0), (0.5, 1.0)):
        hip = np.asarray([hip_x, 0.0, z0])
        knee = hip + np.asarray([0.08 * direction, 0.0, -0.27])
        ankle = knee + np.asarray([-0.06 * direction, 0.0, -0.25])
        toe = ankle + np.asarray([0.16 * direction, 0.0, 0.0])

        thigh = b.body(com=(hip + knee) / 2.0, mass=0.8, inertia=0.03)
        b.hinge(torso, thigh, hip, limit=(-1.0, 1.0), gear=30.0)
        shin = b.body(com=(knee + ankle) / 2.0, mass=0.6, inertia=0.03)
        b.hinge(thigh, shin, knee, limit=(-1.2, 1.2), gear=30.0)
        foot = b.body(com=(ankle + toe) / 2.0, mass=0.3, inertia=0.02)
        b.hinge(shin, foot, ankle, limit=(-0.7, 0.7), gear=15.0)
        b.sphere(foot, ankle, 0.07)
        b.sphere(foot, toe, 0.07)
    return b.build()


class _PlanarLocomotion(_Locomotion):
    """Planar chain robot running in +x. Observation (x excluded):
    [torso_z, torso_pitch, joint_angles (nj), torso vx, vz, pitch velocity,
    joint velocities (nj)] — width 5 + 2 nj."""

    _builder = None  # subclass hook
    _healthy_z: Tuple[float, float] = (0.7, 2.0)
    _healthy_pitch: float = 1.0
    _terminates: bool = True

    def __init__(self, max_steps: int = 1000, reset_noise: float = 0.005):
        self._max_steps = int(max_steps)
        self._reset_noise = float(reset_noise)
        self._sys, self._rest_pos = type(self)._builder()
        self._obs_dim = 5 + 2 * self._nj

    def _pitch(self, body: RigidBodyState) -> torch.Tensor:
        # Planar quats stay in the (w, y) subspace: signed rotation about +y.
        return 2.0 * torch.atan2(body.quat[:, 0, 2], body.quat[:, 0, 0])

    def _healthy(self, sys: RigidBodySystem, body: RigidBodyState) -> Optional[torch.Tensor]:
        if not self._terminates:
            return None
        torso_z = body.pos[:, 0, 2]
        return ((torso_z > self._healthy_z[0]) & (torso_z < self._healthy_z[1])
                & (torch.abs(self._pitch(body)) < self._healthy_pitch))

    def _observe(self, sys: RigidBodySystem, state: LocoState) -> Observation:
        body = state.body
        view = torch.cat([
            body.pos[:, 0, 2:3],
            self._pitch(body)[:, None],
            joint_angles(sys, body),
            body.vel[:, 0, 0:1],
            body.vel[:, 0, 2:3],
            body.ang[:, 0, 1:2],
            joint_velocities(sys, body),
        ], dim=-1)
        return Observation(view, self._mask(view), state.step_count)


class Hopper(_PlanarLocomotion):
    """Planar monoped (obs 11, actions 3)."""

    _builder = staticmethod(_build_hopper)
    _healthy_z = (0.8, 2.0)
    _healthy_pitch = 0.4
    _ctrl_cost_weight = 0.001


class Walker2d(_PlanarLocomotion):
    """Planar biped (obs 17, actions 6)."""

    _builder = staticmethod(_build_walker2d)
    _healthy_z = (0.8, 2.0)
    _healthy_pitch = 1.0
    _ctrl_cost_weight = 0.001


class HalfCheetah(_PlanarLocomotion):
    """Planar runner (obs 17, actions 6), no healthy-band termination."""

    _builder = staticmethod(_build_halfcheetah)
    _healthy_reward = 0.0
    _ctrl_cost_weight = 0.1
    _terminates = False
