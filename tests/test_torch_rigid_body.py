"""The port's rigid-body engine (stoix_tpu_torch/envs/rigid_body.py) against
the JAX package's, on the CPU, from numpy seeds and from the JAX envs' own
states:

1. The quaternion helpers on random inputs: quat_mul, quat_conj,
   quat_rotate, quat_inv_rotate and cross bitwise against `jax.jit` of the
   JAX helpers (XLA's fused multiply-adds stated); quat_integrate and
   quat_twist_angle within 1e-6 relative (a float32 root and atan2).
2. From JAX's states (Ant at rest, perturbed at reset, standing in contact,
   lifted into flight; Hopper at reset and after random steps), under random
   actions: the joints' and contacts' force and torque, and one substep,
   within 1e-5 relative with an absolute floor of 1e-6 of each field's
   scale; one control step (16 substeps) within 1e-5 relative with a floor
   of 1e-5 of the field's scale. At a 1e-6 floor the control step misses
   (Ant's velocities by up to 3.6x the bound, Walker2d's by 1.5x): XLA
   rounds the engine's float32 arithmetic differently in each program it
   compiles (a multiply feeding an add is one fused multiply-add in some
   vector lanes, not in others), and the JAX engine's own two compilations
   of a control step (`step` under `lax.scan` and 16 jitted `_substep`s)
   part by up to 3.3x that bound on Ant; the stiff joint springs carry a
   few ulps of a substep into the velocities
   (`scripts/jax_rigid_body_parity.py` prints both).
3. The accumulation order: contributions with duplicate body indices summed
   as XLA's scatter-add adds them (the children's in joint order, then the
   parents'), held bitwise against `jax.jit` of `.at[].add` on values whose
   sum depends on the order.
4. The JAX package's oracles (tests/test_rigid_body.py) on the port: free
   fall, a dropped ball settling, a pendulum swinging and keeping its energy
   bounded, the joint angle and velocity measurement, actuation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.envs import locomotion as jax_locomotion
from stoix_tpu.envs import rigid_body as jrb
from stoix_tpu_torch.envs import locomotion
from stoix_tpu_torch.envs import rigid_body as rb
from torch_parity import n, t

SYSTEM_FIELDS = ("mass", "inertia", "static", "joint_parent", "joint_child", "anchor_p",
                 "anchor_c", "axis_p", "limit", "gear", "sphere_body", "sphere_offset",
                 "sphere_radius")


def port_system(jax_sys) -> rb.RigidBodySystem:
    """The port's system with the JAX system's arrays and scalars."""
    arrays = {f: np.asarray(getattr(jax_sys, f)) for f in SYSTEM_FIELDS}
    scalars = {f: getattr(jax_sys, f) for f in jax_sys._fields if f not in arrays}
    return rb.make_system(**arrays, **scalars)


def port_state(jax_state) -> rb.RigidBodyState:
    return rb.RigidBodyState(*(t(x) for x in jax_state))


def assert_close(got, want, rtol: float, floor: float) -> None:
    """|got - want| <= rtol |want| + floor max|want|, elementwise."""
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, rtol=rtol, atol=floor * np.abs(want).max())


# ------------------------------------------------------------------ helpers


def _quats(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


HELPERS = {
    # name: (JAX helper, port helper, inputs from a rng, bitwise)
    "quat_mul": (jrb.quat_mul, rb.quat_mul, lambda r: (_quats(r, (4096,)), _quats(r, (4096,))),
                 True),
    "quat_conj": (jrb.quat_conj, rb.quat_conj, lambda r: (_quats(r, (4096,)),), True),
    "quat_rotate": (jrb.quat_rotate, rb.quat_rotate,
                    lambda r: (_quats(r, (4096,)), r.normal(size=(4096, 3)).astype(np.float32)),
                    True),
    "quat_inv_rotate": (jrb.quat_inv_rotate, rb.quat_inv_rotate,
                        lambda r: (_quats(r, (4096,)),
                                   r.normal(size=(4096, 3)).astype(np.float32)), True),
    "cross": (jnp.cross, rb.cross, lambda r: tuple(r.normal(size=(4096, 3)).astype(np.float32)
                                                   for _ in range(2)), True),
    "quat_integrate": (lambda q, w: jrb.quat_integrate(q, w, 0.002),
                       lambda q, w: rb.quat_integrate(q, w, 0.002),
                       lambda r: (_quats(r, (4096,)),
                                  (3 * r.normal(size=(4096, 3))).astype(np.float32)), False),
    "quat_twist_angle": (jrb.quat_twist_angle, rb.quat_twist_angle,
                         lambda r: (_quats(r, (4096,)),
                                    _quats(r, (4096,))[:, 1:] / 1.0), False),
}


@pytest.mark.parametrize("name", list(HELPERS))
def test_quaternion_helper_matches_jax(name):
    jax_fn, port_fn, inputs, bitwise = HELPERS[name]
    args = inputs(np.random.default_rng(sorted(HELPERS).index(name)))
    want = np.asarray(jax.jit(jax_fn)(*args))
    got = n(port_fn(*(t(a) for a in args)))
    if bitwise:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ from JAX's states


@pytest.fixture(scope="module")
def jax_states():
    """name -> (JAX env, JAX body state [E, ...], actions [E, nj]) from the JAX
    envs: Ant at rest, at reset (perturbed), standing in contact after 20
    zero-action steps, lifted 0.5 into flight; Hopper at reset and after 20
    random steps."""
    num_envs, rng, out = 16, np.random.default_rng(0), {}
    for name in ("Ant", "Hopper"):
        env = getattr(jax_locomotion, name)()
        nj = env._sys.num_joints
        state, _ = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(1), num_envs))
        step = jax.jit(jax.vmap(env.step))
        actions = lambda: rng.uniform(-1, 1, (num_envs, nj)).astype(np.float32)  # noqa: E731
        if name == "Ant":
            rest = jax.tree.map(lambda x: jnp.broadcast_to(x, (num_envs,) + x.shape),
                                jrb.rest_state(env._sys, env._rest_pos))
            out["ant_rest"] = (env, rest, np.zeros((num_envs, nj), np.float32))
            out["ant_perturbed"] = (env, state.body, actions())
            standing = state
            for _ in range(20):
                standing, _ = step(standing, jnp.zeros((num_envs, nj)))
            out["ant_contact"] = (env, standing.body, actions())
            out["ant_flight"] = (env, standing.body._replace(
                pos=standing.body.pos + jnp.asarray([0.0, 0.0, 0.5])), actions())
        else:
            out["hopper_reset"] = (env, state.body, actions())
            for _ in range(20):
                state, _ = step(state, jnp.asarray(actions()))
            out["hopper_running"] = (env, state.body, actions())
    return out


STATES = ["ant_rest", "ant_perturbed", "ant_contact", "ant_flight", "hopper_reset",
          "hopper_running"]


@pytest.mark.parametrize("name", STATES)
def test_forces_and_one_substep_match_jax(name, jax_states):
    env, body, action = jax_states[name]
    sys = port_system(env._sys)

    def jax_forces(s, a):
        fj, tj = jrb._accumulate_joint_forces(env._sys, s, a)
        fc, tc = jrb._accumulate_contact_forces(env._sys, s)
        return fj + fc, tj + tc

    force, torque = jax.jit(jax.vmap(jax_forces))(body, jnp.asarray(action))
    got_force, got_torque = rb._forces(sys, port_state(body), t(action))
    assert_close(got_force, force, 1e-5, 1e-6)
    assert_close(got_torque, torque, 1e-5, 1e-6)
    want = jax.jit(jax.vmap(lambda s, a: jrb._substep(env._sys, s, a)))(body, jnp.asarray(action))
    got = rb._substep(sys, port_state(body), t(action))
    for field, w, g in zip(want._fields, want, got):
        assert_close(g, w, 1e-5, 1e-6)


@pytest.mark.parametrize("name", STATES)
def test_one_control_step_matches_jax(name, jax_states):
    env, body, action = jax_states[name]
    want = jax.jit(jax.vmap(lambda s, a: jrb.step(env._sys, s, a)))(body, jnp.asarray(action))
    got = rb.step(port_system(env._sys), port_state(body), t(action))
    for w, g in zip(want, got):
        assert_close(g, w, 1e-5, 1e-5)
    if name == "ant_rest":  # no spring stretched: a floor of 1e-6 of the scale holds
        for w, g in zip(want, got):
            assert_close(g, w, 1e-5, 1e-6)


def test_port_systems_are_the_jax_systems():
    for name in ("Ant", "Hopper", "Walker2d", "HalfCheetah"):
        jenv, env = getattr(jax_locomotion, name)(), getattr(locomotion, name)()
        for field in SYSTEM_FIELDS:
            np.testing.assert_array_equal(n(getattr(env._sys, field)),
                                          np.asarray(getattr(jenv._sys, field)))
        np.testing.assert_array_equal(env._rest_pos, jenv._rest_pos)
        assert (env._sys.hold_kp, env._sys.hold_kd, env._sys.planar) == (
            jenv._sys.hold_kp, jenv._sys.hold_kd, jenv._sys.planar)


# ----------------------------------------------------------- accumulation order


def test_accumulation_adds_duplicates_in_xla_scatter_order():
    """Ant's joint targets (children then parents): the torso takes four
    parent contributions, each upper leg a child's and a parent's. Values of
    mixed magnitude make the float32 sum depend on the order; the rounds add
    them as `jax.jit` of `.at[c].add(x).at[p].add(-x)` does, bitwise, and a
    different order would not."""
    sys = locomotion.Ant()._sys
    child, parent = n(sys.joint_child), n(sys.joint_parent)
    rng = np.random.default_rng(0)
    values = (rng.normal(size=(64, 8, 3)) * 10.0 ** rng.integers(-4, 8, size=(64, 8, 3))
              ).astype(np.float32)

    def jax_sum(x):
        return jnp.zeros((64, 9, 3), jnp.float32).at[:, child].add(x).at[:, parent].add(-x)

    want = np.asarray(jax.jit(jax_sum)(values))
    got = rb.accumulate(torch.cat([t(values), -t(values)], dim=1), sys.joint_rounds)
    np.testing.assert_array_equal(n(got), want)
    # The torso's four adds in the reverse order part from it somewhere.
    reverse = np.zeros((64, 3), np.float32)
    for j in reversed(range(0, 8, 2)):
        reverse = reverse + -values[:, j]
    assert not np.array_equal(reverse, want[:, 0])


# ------------------------------------------------------------------ oracles


def _free_body_system(radius=0.1):
    return rb.make_system(
        mass=[1.0], inertia=[[1.0, 1.0, 1.0]], static=[0.0], joint_parent=[], joint_child=[],
        anchor_p=np.zeros((0, 3)), anchor_c=np.zeros((0, 3)), axis_p=np.zeros((0, 3)),
        limit=np.zeros((0, 2)), gear=[], sphere_body=[0], sphere_offset=[[0.0, 0.0, 0.0]],
        sphere_radius=[radius], lin_damping=0.0, ang_damping=0.0)


def _pendulum_system(gear=0.0):
    """Static base at the origin; 2 m rod child whose COM hangs 1 m from it."""
    return rb.make_system(
        mass=[1.0, 1.0], inertia=[[1.0] * 3, [1.0 / 3.0] * 3], static=[1.0, 0.0],
        joint_parent=[0], joint_child=[1], anchor_p=[[0.0, 0.0, 0.0]],
        anchor_c=[[-1.0, 0.0, 0.0]], axis_p=[[0.0, 1.0, 0.0]], limit=[[-10.0, 10.0]],
        gear=[gear], sphere_body=[], sphere_offset=np.zeros((0, 3)), sphere_radius=[],
        lin_damping=0.0, ang_damping=0.0)


def _at(sys, positions):
    return rb.rest_state(sys, torch.tensor(positions, dtype=torch.float32), 1)


def test_free_fall_matches_kinematics():
    sys = _free_body_system()
    state = _at(sys, [[0.0, 0.0, 100.0]])
    for _ in range(10):
        state = rb.step(sys, state, torch.zeros((1, 0)))
    elapsed = sys.dt * sys.substeps * 10
    assert abs(float(state.pos[0, 0, 2]) - (100.0 - 0.5 * 9.81 * elapsed ** 2)) < 0.01


def test_dropped_ball_settles_on_ground():
    sys = _free_body_system()
    state = _at(sys, [[0.0, 0.0, 0.5]])
    for _ in range(400):
        state = rb.step(sys, state, torch.zeros((1, 0)))
    assert abs(float(state.pos[0, 0, 2]) - 0.1) < 0.01  # rests at the sphere's radius
    assert float(torch.linalg.vector_norm(state.vel)) < 1e-3


def test_pendulum_swings_through_its_range_and_keeps_its_energy_bounded():
    sys = _pendulum_system()
    state = _at(sys, [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    z_min, z_max, anchor_err = 0.0, -10.0, 0.0
    for _ in range(300):
        state = rb.step(sys, state, torch.zeros((1, 1)))
        z = float(state.pos[0, 1, 2])
        z_min, z_max = min(z_min, z), max(z_max, z)
        anchor = state.pos[0, 1] + rb.quat_rotate(state.quat[0, 1], sys.anchor_c[0])
        anchor_err = max(anchor_err, float(torch.linalg.vector_norm(anchor)))
    assert z_min < -0.95 and z_max < 0.05  # released horizontally: through the bottom, back
    assert anchor_err < 0.01  # the joint stays assembled
    np.testing.assert_allclose(n(state.pos[0, 0]), 0.0, atol=1e-7)  # the base never moves
    omega_b = rb.quat_inv_rotate(state.quat[0, 1], state.ang[0, 1])
    energy = float(9.81 * state.pos[0, 1, 2] + 0.5 * torch.sum(state.vel[0, 1] ** 2)
                   + 0.5 * torch.sum(sys.inertia[1] * omega_b ** 2))
    assert -0.5 < energy < 0.05  # started at rest at z = 0: no energy injected


def test_joint_angle_and_velocity_measurement():
    sys = _pendulum_system()
    state = _at(sys, [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    quat = state.quat.clone()
    quat[0, 1] = torch.tensor([np.cos(0.15), 0.0, np.sin(0.15), 0.0])  # 0.3 rad about y
    ang = state.ang.clone()
    ang[0, 1] = torch.tensor([0.0, 2.0, 0.0])
    state = state._replace(quat=quat, ang=ang)
    np.testing.assert_allclose(n(rb.joint_angles(sys, state)), [[0.3]], atol=1e-5)
    np.testing.assert_allclose(n(rb.joint_velocities(sys, state)), [[2.0]], atol=1e-5)


def test_actuation_torque_moves_the_joint():
    sys = _pendulum_system(gear=30.0)
    down = torch.tensor([np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0], dtype=torch.float32)
    state = rb.rest_state(sys, torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0]]), 2)
    quat = state.quat.clone()
    quat[:, 1] = down
    state = state._replace(quat=quat)  # hanging straight down: an equilibrium
    anchor = state.pos[0, 1] + rb.quat_rotate(down, sys.anchor_c[0])
    np.testing.assert_allclose(n(anchor), 0.0, atol=1e-6)
    action = torch.tensor([[1.0], [0.0]])  # env 0 driven, env 1 passive
    for _ in range(50):
        state = rb.step(sys, state, action)
    angles = n(rb.joint_angles(sys, state))
    assert float(torch.linalg.vector_norm(state.vel[1, 1])) < 0.05  # the equilibrium holds
    assert abs(angles[0, 0] - angles[1, 0]) > 0.3  # the actuator swings the pendulum
