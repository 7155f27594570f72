"""Maximal-coordinate rigid-body physics as batched tensor code (counterpart
of stoix_tpu/envs/rigid_body.py).

The engine is the JAX package's: spring hinge joints (anchor spring, swing
spring, angle limits, actuation, passive hold PD), sphere-vs-plane penalty
contacts with Coulomb-capped viscous friction, and semi-implicit Euler over
`substeps` substeps a control step, in the JAX package's op order. Here every
state tensor carries a leading env axis: pos [E, nb, 3], quat [E, nb, 4]
(wxyz), vel [E, nb, 3], ang [E, nb, 3] (world frame), and one substep of every
env is a fixed set of tensor ops with no host read, on the device of the
state. `step` is a Python loop over the substeps.

Accumulation order. The JAX package scatters each joint's force and torque
onto its bodies with `.at[].add`, the children's contributions in joint order
and then the parents' (`force.at[c].add(f_c).at[p].add(-f_c)`); the contacts'
in sphere order into a second array, added after. XLA on the CPU adds a
scatter's updates in index order, so a body's sum is a fixed sequence of
float32 adds. `index_add_` on CUDA adds with atomics in no fixed order, so the
port never scatters: `accumulation_rounds` lists every body's contributions
in XLA's order, and `accumulate` adds them round by round, one gather and one
add a round, so card and CPU add in the same order as XLA, every run.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from stoix_tpu_torch.kernels.linear_recurrence import fma_f32

# --- float32 semantics -------------------------------------------------------
#
# XLA on the CPU contracts a multiply feeding an add into one fused
# multiply-add: `a * b + c` and `a * b - c * d` round once at the add (the
# first product is the fused one), and a sum of products over the last axis
# is a chain of them. The JAX engine is held here in that arithmetic: each
# such expression is one `fma`, so the port's states follow JAX's to a few
# ulps (`scripts/jax_rigid_body_parity.py` measures how far).

_MUL_PERM = ((1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0))
_MUL_SIGN = ((-1.0, 1.0, -1.0, 1.0), (-1.0, 1.0, 1.0, -1.0), (-1.0, -1.0, 1.0, 1.0))
_CONJ = (1.0, -1.0, -1.0, -1.0)
_CROSS_A = (1, 2, 0)
_CROSS_B = (2, 0, 1)


@functools.lru_cache(maxsize=None)
def _constant(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A float32 constant on `device` (a 0-d tensor for one value), made once."""
    out = torch.tensor(values, dtype=torch.float32, device=device)
    return out.reshape(()) if len(values) == 1 else out


def _const(values, like: torch.Tensor) -> torch.Tensor:
    values = tuple(float(v) for v in values) if isinstance(values, (tuple, list)) else (
        float(values),)
    return _constant(values, like.device)


@functools.lru_cache(maxsize=None)
def _index(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _cpu_addcmul_is_fma() -> bool:
    """Whether this host's CPU `torch.addcmul` rounds once (its kernels use
    the CPU's fused multiply-add), checked once against `fma_f32` on values
    where one and two roundings differ: contiguous (vector body and scalar
    tail), with a broadcast 0-d operand, and strided, as the engine calls it."""
    generator = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn((4099, 3), generator=generator) for _ in range(3))
    scalar = torch.tensor(0.7)
    cases = ((a, b, c), (scalar, b, c), (a[:, 1:], b[:, :2], c[:, ::2]))
    return all(bool(torch.equal(torch.addcmul(z, x, y),
                                fma_f32(*torch.broadcast_tensors(x, y, z))))
               for x, y, z in cases)


def fused_multiply_add(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a . b + c rounded once (broadcasting): one `torch.addcmul` launch on
    the card, whose kernel nvcc contracts into one fmaf, and on a CPU whose
    `addcmul` rounds once; `fma_f32` (exact, in float64) on any other."""
    if c.is_cuda or _cpu_addcmul_is_fma():
        return torch.addcmul(c, a, b)
    return fma_f32(*torch.broadcast_tensors(a, b, c))


def fma(a, b, c: torch.Tensor) -> torch.Tensor:
    """a . b + c rounded once (broadcasting); a Python float `a` or `b` is a
    float32 constant."""
    a = _const(a, c) if isinstance(a, (int, float)) else a
    b = _const(b, c) if isinstance(b, (int, float)) else b
    return fused_multiply_add(a, b, c)


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """`jnp.sum(a * b, axis=-1)` as XLA reduces it: the first product, then
    one fused multiply-add a term."""
    out = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        out = fma(a[..., i], b[..., i], out)
    return out[..., None] if keepdim else out


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA's. The CPU's
    vectorised `torch.sqrt` is not always correctly rounded, so there it goes
    through float64 (exact after rounding back); CUDA's is IEEE."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


def norm(x: torch.Tensor) -> torch.Tensor:
    """`jnp.linalg.norm(x, axis=-1, keepdims=True)`: the root of `dot(x, x)`."""
    return sqrt(dot(x, x, keepdim=True))


# --- quaternion helpers (wxyz convention, any leading axes) -------------------


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product; a, b [..., 4] (broadcasting). As the JAX package
    writes it, term by term:
      w = aw bw - ax bx - ay by - az bz      x = aw bx + ax bw + ay bz - az by
      y = aw by - ax bz + ay bw + az bx      z = aw bz + ax by - ay bx + az bw
    the terms after aw . b being a's i-th component times b permuted by
    _MUL_PERM[i - 1], signed by _MUL_SIGN[i - 1], added left to right (each
    add one fused multiply-add, the first taking aw . b)."""
    permuted = b[..., _index(sum(_MUL_PERM, ()), b.device)].unflatten(-1, (3, 4))
    signed = a[..., 1:, None] * _const(sum(_MUL_SIGN, ()), a).reshape(3, 4)
    out = fma(a[..., :1], b, signed[..., 0, :] * permuted[..., 0, :])
    for i in (1, 2):
        out = fma(signed[..., i, :], permuted[..., i, :], out)
    return out


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * _const(_CONJ, q)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.cross` over the last axis (broadcasting): a1 b2 - a2 b1 and its
    rotations, each one fused multiply-add."""
    first, second = _index(_CROSS_A, a.device), _index(_CROSS_B, a.device)
    return fma(a[..., first], b[..., second], -(a[..., second] * b[..., first]))


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by quaternions q [..., 4]."""
    qv = q[..., 1:]
    uv = cross(qv, v)
    uuv = cross(qv, uv)
    return v + 2.0 * fma(q[..., :1], uv, uuv)


def quat_inv_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt: float) -> torch.Tensor:
    """q <- normalize(q + dt/2 * [0, omega] (x) q); omega in world frame."""
    dq = quat_mul(torch.nn.functional.pad(omega, (1, 0)), q)
    q = fma(0.5 * dt, dq, q)
    return q / norm(q)


def quat_twist_angle(q_rel: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Signed rotation of q_rel about `axis` (swing-twist decomposition)."""
    proj = dot(q_rel[..., 1:], axis)
    return 2.0 * torch.atan2(proj, q_rel[..., 0])


# --- system description ------------------------------------------------------


def accumulation_rounds(targets: Sequence[int], num_bodies: int) -> torch.Tensor:
    """[R, num_bodies] int64: round r's entry for body b is the index (into
    the contributions `targets` addresses, in order) of b's r-th
    contribution, or len(targets) (a zero row) where b has fewer than r + 1.
    Contributions reach a body in the order `targets` lists them, as XLA's
    scatter-add adds its updates."""
    per_body: List[List[int]] = [[] for _ in range(num_bodies)]
    for k, body in enumerate(targets):
        per_body[int(body)].append(k)
    rounds = max([len(c) for c in per_body] + [1])
    table = [[c[r] if r < len(c) else len(targets) for c in per_body] for r in range(rounds)]
    return torch.tensor(table, dtype=torch.int64)


def accumulate(contributions: torch.Tensor, rounds: torch.Tensor) -> torch.Tensor:
    """Sum [E, K, D] contributions onto [E, nb, D] bodies in the fixed order
    of `rounds` ([R, nb], from `accumulation_rounds`): round 0 gathers each
    body's first contribution (0 + x is x, as XLA's first add into zeros),
    each later round adds the next."""
    padded = torch.nn.functional.pad(contributions, (0, 0, 0, 1))
    out = padded.index_select(1, rounds[0])
    for r in range(1, rounds.shape[0]):
        out = out + padded.index_select(1, rounds[r])
    return out


class RigidBodySystem(NamedTuple):
    """Static description of an articulated rigid-body system (the JAX
    package's fields, defaults and units), plus the gather tables the
    batched substep uses. Build it with `make_system`; `to(device)` moves
    its tensors."""

    # Bodies.
    mass: torch.Tensor  # [nb]
    inertia: torch.Tensor  # [nb, 3] diagonal body-frame inertia
    static: torch.Tensor  # [nb] 1.0 = immovable
    # Hinge joints (parent -> child).
    joint_parent: torch.Tensor  # [nj] int64
    joint_child: torch.Tensor  # [nj] int64
    anchor_p: torch.Tensor  # [nj, 3] anchor in parent frame
    anchor_c: torch.Tensor  # [nj, 3] anchor in child frame
    axis_p: torch.Tensor  # [nj, 3] hinge axis in parent frame (unit)
    limit: torch.Tensor  # [nj, 2] (lo, hi) joint angle limits, radians
    gear: torch.Tensor  # [nj] actuator torque scale
    # Contact spheres.
    sphere_body: torch.Tensor  # [ns] int64
    sphere_offset: torch.Tensor  # [ns, 3] centre in body frame
    sphere_radius: torch.Tensor  # [ns]
    # Derived by make_system: every point the substep reads, parents' anchors
    # then children's then sphere centres, with the body each rides on.
    point_body: torch.Tensor  # [2 nj + ns] int64
    point_offset: torch.Tensor  # [2 nj + ns, 3] offset in that body's frame
    joint_rounds: torch.Tensor  # [R, nb] over [children's nj; parents' nj]
    contact_rounds: torch.Tensor  # [R', nb] over the ns spheres
    inv_mass: torch.Tensor  # [nb] float32 reciprocals, as XLA folds them
    inv_inertia: torch.Tensor  # [nb, 3]
    movable: Optional[torch.Tensor]  # [nb, 1] 1 - static; None when no body is static
    # Scalars.
    gravity: float = -9.81
    dt: float = 0.002
    substeps: int = 16
    joint_kp: float = 10_000.0
    joint_kd: float = 50.0
    swing_kp: float = 500.0
    swing_kd: float = 2.0
    limit_kp: float = 1_000.0
    hold_kp: float = 0.0
    hold_kd: float = 0.0
    contact_kp: float = 10_000.0
    contact_kd: float = 50.0
    friction: float = 1.0
    friction_kv: float = 50.0
    lin_damping: float = 0.02
    ang_damping: float = 0.05
    planar: bool = False

    @property
    def num_bodies(self) -> int:
        return self.mass.shape[0]

    @property
    def num_joints(self) -> int:
        return self.joint_parent.shape[0]

    def to(self, device) -> "RigidBodySystem":
        return RigidBodySystem(*(x.to(device) if isinstance(x, torch.Tensor) else x
                                 for x in self))


def make_system(mass, inertia, static, joint_parent, joint_child, anchor_p, anchor_c, axis_p,
                limit, gear, sphere_body, sphere_offset, sphere_radius, **scalars
                ) -> RigidBodySystem:
    """A RigidBodySystem from array-likes (float32 and int64 on the CPU) and
    the scalar fields' overrides, with its gather tables."""
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    i64 = lambda x: torch.tensor(np.asarray(x, np.int64))  # noqa: E731
    mass, inertia, static = f32(mass), f32(inertia).reshape(-1, 3), f32(static)
    joint_parent, joint_child = i64(joint_parent).reshape(-1), i64(joint_child).reshape(-1)
    anchor_p, anchor_c = f32(anchor_p).reshape(-1, 3), f32(anchor_c).reshape(-1, 3)
    sphere_body = i64(sphere_body).reshape(-1)
    sphere_offset = f32(sphere_offset).reshape(-1, 3)
    nb = mass.shape[0]
    return RigidBodySystem(
        mass=mass, inertia=inertia, static=static, joint_parent=joint_parent,
        joint_child=joint_child, anchor_p=anchor_p, anchor_c=anchor_c,
        axis_p=f32(axis_p).reshape(-1, 3), limit=f32(limit).reshape(-1, 2), gear=f32(gear),
        sphere_body=sphere_body, sphere_offset=sphere_offset,
        sphere_radius=f32(sphere_radius).reshape(-1),
        point_body=torch.cat([joint_parent, joint_child, sphere_body]),
        point_offset=torch.cat([anchor_p, anchor_c, sphere_offset]),
        joint_rounds=accumulation_rounds(torch.cat([joint_child, joint_parent]).tolist(), nb),
        contact_rounds=accumulation_rounds(sphere_body.tolist(), nb),
        inv_mass=1.0 / mass, inv_inertia=1.0 / inertia,
        movable=(1.0 - static)[:, None] if bool((static != 0).any()) else None,
        **scalars,
    )


class RigidBodyState(NamedTuple):
    pos: torch.Tensor  # [E, nb, 3]
    quat: torch.Tensor  # [E, nb, 4] wxyz
    vel: torch.Tensor  # [E, nb, 3]
    ang: torch.Tensor  # [E, nb, 3] world-frame angular velocity


def rest_state(sys: RigidBodySystem, rest_pos: torch.Tensor, num_envs: int) -> RigidBodyState:
    """Every env at `rest_pos` [nb, 3], unrotated and at rest (on the
    device of `rest_pos`)."""
    pos = rest_pos.to(torch.float32).expand(num_envs, -1, -1).clone()
    quat = torch.zeros((num_envs, sys.num_bodies, 4), dtype=torch.float32, device=pos.device)
    quat[..., 0] = 1.0
    return RigidBodyState(pos, quat, torch.zeros_like(pos), torch.zeros_like(pos))


# --- dynamics ----------------------------------------------------------------


def _relative_rotation(qp: torch.Tensor, qc: torch.Tensor) -> torch.Tensor:
    """conj(qp) (x) qc with its sign canonicalised (w >= 0)."""
    q_rel = quat_mul(quat_conj(qp), qc)
    return torch.where(q_rel[..., :1] < 0, -q_rel, q_rel)


def joint_angles(sys: RigidBodySystem, state: RigidBodyState) -> torch.Tensor:
    """Signed hinge angles [E, nj] via swing-twist about each joint axis."""
    q_rel = _relative_rotation(state.quat[:, sys.joint_parent], state.quat[:, sys.joint_child])
    return quat_twist_angle(q_rel, sys.axis_p)


def joint_velocities(sys: RigidBodySystem, state: RigidBodyState) -> torch.Tensor:
    """Relative angular velocity about each (world-frame) joint axis [E, nj]."""
    axis_w = quat_rotate(state.quat[:, sys.joint_parent], sys.axis_p)
    omega_rel = state.ang[:, sys.joint_child] - state.ang[:, sys.joint_parent]
    return dot(omega_rel, axis_w)


def _forces(sys: RigidBodySystem, state: RigidBodyState, action: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Force and torque [E, nb, 3] from the joints and the ground contacts,
    each accumulated in XLA's order (joints fj + contacts fc, as the JAX
    substep adds them). `action` is [E, nj] in [-1, 1]."""
    nj = sys.num_joints
    # Every point the substep reads: its body's state and its world offset.
    packed = torch.cat([state.pos, state.quat, state.vel, state.ang], dim=-1)
    at = packed.index_select(1, sys.point_body)
    pos_g, quat_g, vel_g, ang_g = at.split((3, 4, 3, 3), dim=-1)
    offset = quat_rotate(quat_g, sys.point_offset)  # lever arms
    point = pos_g + offset
    point_vel = vel_g + cross(ang_g, offset)

    # Joints: parents' points [:nj], children's [nj:2nj].
    rp, rc = offset[:, :nj], offset[:, nj:2 * nj]
    qp, qc = quat_g[:, :nj], quat_g[:, nj:2 * nj]
    f_c = fma(sys.joint_kp, point[:, :nj] - point[:, nj:2 * nj],
              sys.joint_kd * (point_vel[:, :nj] - point_vel[:, nj:2 * nj]))  # on child
    q_rel = _relative_rotation(qp, qc)
    rotvec = 2.0 * q_rel[..., 1:]
    swing = rotvec - dot(rotvec, sys.axis_p, keepdim=True) * sys.axis_p  # minus the twist
    # Both rotations by qp at once: the swing error and the hinge axis.
    rotated = quat_rotate(qp[:, :, None], torch.stack([swing, sys.axis_p.expand_as(rotvec)],
                                                      dim=2))
    swing_err_w, axis_w = rotated[:, :, 0], rotated[:, :, 1]
    omega_rel = ang_g[:, nj:2 * nj] - ang_g[:, :nj]
    omega_axis = dot(omega_rel, axis_w, keepdim=True)
    omega_swing = fma(-omega_axis, axis_w, omega_rel)
    tau_swing = fma(-sys.swing_kp, swing_err_w, -(sys.swing_kd * omega_swing))
    angle = quat_twist_angle(q_rel, sys.axis_p)
    lo, hi = sys.limit[:, 0], sys.limit[:, 1]
    limit_err = torch.where(angle < lo, lo - angle,
                            torch.where(angle > hi, hi - angle, torch.zeros_like(angle)))
    drive = fma(sys.limit_kp, limit_err, sys.gear * action)
    drive = fma(-sys.hold_kp, angle, drive)
    drive = fma(-sys.hold_kd, omega_axis[..., 0], drive)
    tau_c = fma(drive[..., None], axis_w, tau_swing)  # tau_swing + tau_axis
    neg_f = -f_c
    lever = cross(torch.cat([rc, rp], dim=1), torch.cat([f_c, neg_f], dim=1))
    joint = torch.cat([torch.cat([f_c, neg_f], dim=1),
                       lever + torch.cat([tau_c, -tau_c], dim=1)], dim=-1)

    # Contacts: the sphere centres [2nj:].
    r_off, centre, contact_vel = offset[:, 2 * nj:], point[:, 2 * nj:], point_vel[:, 2 * nj:]
    depth = sys.sphere_radius - centre[..., 2]  # > 0 when penetrating
    active = depth > 0.0
    normal_mag = torch.where(
        active, fma(sys.contact_kp, depth, -(sys.contact_kd * contact_vel[..., 2])),
        torch.zeros_like(depth))
    normal_mag = torch.clamp_min(normal_mag, 0.0)  # ground only pushes
    tangential = contact_vel[..., :2]  # the z component is set to 0
    t_speed = norm(tangential) + 1e-8
    friction_mag = torch.minimum(sys.friction_kv * t_speed, sys.friction * normal_mag[..., None])
    f = torch.cat([-friction_mag * tangential / t_speed, normal_mag[..., None]], dim=-1)
    f = torch.where(active[..., None], f, torch.zeros_like(f))
    contact = torch.cat([f, cross(r_off, f)], dim=-1)

    total = accumulate(joint, sys.joint_rounds) + accumulate(contact, sys.contact_rounds)
    return total[..., :3], total[..., 3:]


def _substep(sys: RigidBodySystem, state: RigidBodyState, action: torch.Tensor
             ) -> RigidBodyState:
    force, torque = _forces(sys, state, action)
    # XLA folds the constants as the JAX substep is compiled: a division by
    # the constant masses and inertias is a multiply by their float32
    # reciprocals, `dt * (v * damping)` is `v * (dt * damping)`, and with no
    # static body `movable` is 1 and its multiplies vanish. The port does the
    # same (`inv_mass`, `inv_inertia`, `movable`), and contracts as XLA does.
    lin_damping = 1.0 - sys.lin_damping * sys.dt
    ang_damping = 1.0 - sys.ang_damping * sys.dt

    # Linear: gravity + damping, semi-implicit Euler.
    accel = fma(force, sys.inv_mass[:, None], _const((0.0, 0.0, sys.gravity), force))
    if sys.movable is None:
        undamped = fma(accel, sys.dt, state.vel)
        vel = undamped * lin_damping
        pos = fma(undamped, float(np.float32(sys.dt) * np.float32(lin_damping)), state.pos)
    else:
        vel = fma(sys.dt * accel, sys.movable, state.vel) * lin_damping * sys.movable
        pos = fma(sys.dt, vel, state.pos)

    # Angular: Euler's equations in the body frame (diagonal inertia); the
    # angular velocity and the torque rotated into it together.
    body_frame = quat_inv_rotate(state.quat[:, :, None], torch.stack([state.ang, torque], dim=2))
    omega_b, torque_b = body_frame[:, :, 0], body_frame[:, :, 1]
    domega_b = (torque_b - cross(omega_b, sys.inertia * omega_b)) * sys.inv_inertia
    rotated = quat_rotate(state.quat, domega_b)
    if sys.movable is None:
        ang = fma(rotated, sys.dt, state.ang) * ang_damping
    else:
        ang = fma(sys.dt * rotated, sys.movable, state.ang) * ang_damping * sys.movable
    if sys.planar:
        # Hard x-z plane constraint: no y translation, rotation about +y only.
        vel = vel * _const((1.0, 0.0, 1.0), vel)
        pos = pos * _const((1.0, 0.0, 1.0), pos)
        ang = ang * _const((0.0, 1.0, 0.0), ang)
    quat = quat_integrate(state.quat, ang, sys.dt)
    return RigidBodyState(pos, quat, vel, ang)


def step(sys: RigidBodySystem, state: RigidBodyState, action: torch.Tensor) -> RigidBodyState:
    """Advance one control step (`sys.substeps` substeps with held action
    [E, nj]) for every env."""
    for _ in range(sys.substeps):
        state = _substep(sys, state, action)
    return state

