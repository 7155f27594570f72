"""The port's locomotion envs (stoix_tpu_torch/envs/locomotion.py) against
the JAX package's, on the CPU:

1. Ant, Hopper, Walker2d and HalfCheetah are registered under the JAX
   names with observation widths 27, 11, 17 and 17, the same action spaces,
   and systems equal to the JAX package's.
2. `reset_from_draws` from the draws JAX's reset makes (its position
   uniforms, rebuilt from the reset keys, and its velocities, read from its
   reset state): the bodies and the timestep exact.
3. One control step from JAX's states under random actions, for 30 steps
   across episode ends: step types, discounts and truncations exact,
   rewards within 1e-5 relative (floor 1e-6 of their scale), observations
   within 1e-5 relative with a floor of 1e-5 of the observation's scale (a
   1e-6 floor is missed on Ant by 1.6x to 2x, as JAX's own two compilations
   of the step miss it: tests/test_torch_rigid_body.py,
   scripts/jax_rigid_body_parity.py); ten free steps from the same reset
   within 1e-4 relative (floor 1e-4 of the scale).
4. The step's edges against JAX on the same states: truncation at the step
   limit with discount 1, termination from the incoming state's health
   check, and the non-finite path (reward 0, terminated, `nan_to_num`
   observations).
5. The JAX package's oracles (tests/test_rigid_body.py's Ant tests and
   tests/test_planar_locomotion.py) on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.envs import locomotion as jax_locomotion
from stoix_tpu_torch import envs
from stoix_tpu_torch.envs import locomotion
from stoix_tpu_torch.envs.types import tree_select
from torch_parity import n, t

ROBOTS = {"Ant": 27, "Hopper": 11, "Walker2d": 17, "HalfCheetah": 17}


def reset_draws(jax_env, keys, jax_state) -> np.ndarray:
    """[E, 2, nb, 3]: the position uniforms JAX's reset draws from `keys` and
    the velocities of its reset state."""
    nb = jax_env._sys.num_bodies

    def uniform(key):
        _, k_pos, _ = jax.random.split(key, 3)
        return jax.random.uniform(k_pos, (nb, 3), minval=-1.0, maxval=1.0)

    return np.stack([np.asarray(jax.jit(jax.vmap(uniform))(keys)),
                     np.asarray(jax_state.body.vel)], axis=1)


def port_state_of(jax_state, generator):
    """The port's LocoState holding JAX's bodies and step counts."""
    body = locomotion.RigidBodyState(*(t(x) for x in jax_state.body))
    return locomotion.LocoState(generator, body, t(jax_state.step_count))


def assert_close(got, want, rtol, floor):
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, rtol=rtol, atol=floor * np.abs(want).max())


@pytest.mark.parametrize("name", list(ROBOTS))
def test_registered_with_the_jax_spaces_and_widths(name):
    from stoix_tpu.envs.registry import make_single as jax_make_single

    env, jenv = envs.make_single(name), jax_make_single(name)
    assert env.observation_space().agent_view.shape == (ROBOTS[name],)
    assert env.observation_space().agent_view.shape == jenv.observation_space().agent_view.shape
    assert env.action_space().shape == jenv.action_space().shape
    _, ts = env.reset(torch.Generator().manual_seed(0), 3)
    assert ts.observation.agent_view.shape == (3, ROBOTS[name])
    assert ts.observation.action_mask.shape == (3,) + env.action_space().shape


@pytest.mark.parametrize("name", list(ROBOTS))
def test_reset_from_jax_draws(name):
    jenv, env = getattr(jax_locomotion, name)(), getattr(locomotion, name)()
    keys = jax.random.split(jax.random.PRNGKey(3), 16)
    jstate, jts = jax.jit(jax.vmap(jenv.reset))(keys)
    pstate, pts = env.reset_from_draws(t(reset_draws(jenv, keys, jstate)), torch.Generator())
    for got, want in zip(pstate.body, jstate.body):
        np.testing.assert_array_equal(n(got), np.asarray(want))
    np.testing.assert_array_equal(n(pts.observation.agent_view),
                                  np.asarray(jts.observation.agent_view))
    for field in ("step_type", "discount", "reward"):
        np.testing.assert_array_equal(n(getattr(pts, field)), np.asarray(getattr(jts, field)))


@pytest.mark.parametrize("name", list(ROBOTS))
def test_one_control_step_from_jax_states_and_ten_free_steps(name):
    # A short step limit puts truncations among the steps.
    jenv, env = (getattr(jax_locomotion, name)(max_steps=12),
                 getattr(locomotion, name)(max_steps=12))
    nj, num_envs = jenv._sys.num_joints, 16
    reset, step = jax.jit(jax.vmap(jenv.reset)), jax.jit(jax.vmap(jenv.step))
    generator, rng = torch.Generator(), np.random.default_rng(4)
    keys = jax.random.split(jax.random.PRNGKey(4), num_envs)
    jstate, _ = reset(keys)
    free, _ = env.reset_from_draws(t(reset_draws(jenv, keys, jstate)), generator)
    jfree, ends = jstate, 0
    for i in range(30):
        action = rng.uniform(-1, 1, (num_envs, nj)).astype(np.float32)
        pstate, pts = env.step(port_state_of(jstate, generator), t(action))
        jstate, jts = step(jstate, jnp.asarray(action))
        for field in ("step_type", "discount"):
            np.testing.assert_array_equal(n(getattr(pts, field)), np.asarray(getattr(jts, field)))
        np.testing.assert_array_equal(n(pts.extras["truncation"]),
                                      np.asarray(jts.extras["truncation"]))
        assert_close(pts.reward, jts.reward, 1e-5, 1e-6)
        assert_close(pts.observation.agent_view, jts.observation.agent_view, 1e-5, 1e-5)
        if i < 10:  # ten steps run free from the same reset
            free, _ = env.step(free, t(action))
            jfree, _ = step(jfree, jnp.asarray(action))
            if i == 9:
                for w, g in zip(jfree.body, free.body):
                    assert_close(g, w, 1e-4, 1e-4)
        done = np.asarray(jts.step_type) == 2
        if done.any():
            ends += int(done.sum())
            rstate, _ = reset(jax.random.split(jax.random.PRNGKey(100 + i), num_envs))
            flag = jnp.asarray(done)
            jstate = jax.tree.map(
                lambda r, s: jnp.where(flag.reshape(flag.shape + (1,) * (s.ndim - 1)), r, s),
                rstate, jstate)
    assert ends > 0


def _edge_states(name):
    """JAX's reset state of 4 envs and its edited copies: the whole body
    teleported 0.5 down (an unhealthy incoming state) and a NaN velocity."""
    jenv = getattr(jax_locomotion, name)(max_steps=3)
    jstate, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(7), 4))
    sunk = jstate._replace(body=jstate.body._replace(
        pos=jstate.body.pos - jnp.asarray([0.0, 0.0, 0.5])))
    broken = jstate._replace(
        body=jstate.body._replace(vel=jstate.body.vel.at[1, 0, 0].set(jnp.nan)))
    return jenv, jstate, sunk, broken


@pytest.mark.parametrize("name", ["Ant", "Hopper", "HalfCheetah"])
def test_truncation_termination_and_non_finite_steps_match_jax(name):
    jenv, jstate, sunk, broken = _edge_states(name)
    env = getattr(locomotion, name)(max_steps=3)
    step = jax.jit(jax.vmap(jenv.step))
    zeros = np.zeros((4, jenv._sys.num_joints), np.float32)
    generator = torch.Generator()
    # Truncation: three zero-action steps reach the limit with discount 1.
    pstate, jnext = port_state_of(jstate, generator), jstate
    for _ in range(3):
        pstate, pts = env.step(pstate, t(zeros))
        jnext, jts = step(jnext, jnp.asarray(zeros))
    assert n(pts.extras["truncation"]).all() and (n(pts.discount) == 1.0).all()
    assert (n(pts.step_type) == 2).all()
    for jstart in (sunk, broken):
        _, pts = env.step(port_state_of(jstart, generator), t(zeros))
        _, jts = step(jstart, jnp.asarray(zeros))
        for field in ("step_type", "discount"):
            np.testing.assert_array_equal(n(getattr(pts, field)), np.asarray(getattr(jts, field)))
        np.testing.assert_array_equal(n(pts.extras["truncation"]),
                                      np.asarray(jts.extras["truncation"]))
        assert np.isfinite(n(pts.observation.agent_view)).all()
    # The sunk body terminates where the JAX env terminates it (an incoming
    # state out of the band, for the robots that have one)...
    _, pts = env.step(port_state_of(sunk, generator), t(zeros))
    if name != "HalfCheetah":
        assert (n(pts.step_type) == 2).all() and (n(pts.discount) == 0.0).all()
    # ...and the non-finite env ends with reward 0 and finite observations.
    _, pts = env.step(port_state_of(broken, generator), t(zeros))
    assert n(pts.step_type)[1] == 2 and n(pts.discount)[1] == 0.0 and n(pts.reward)[1] == 0.0


# ------------------------------------------------------------------ oracles


def _uniform(rng, env, num_envs):
    return torch.from_numpy(rng.uniform(-1, 1, (num_envs, env._nj)).astype(np.float32))


def test_ant_oracles():
    """tests/test_rigid_body.py's Ant oracles, batched: env 0 holds zero
    action for 300 steps and stays healthy; env 1 acts at random for 200
    steps (reset when it ends), finite, its mean reward in (0.3, 2.5)."""
    env, generator, rng = locomotion.Ant(), torch.Generator().manual_seed(0), \
        np.random.default_rng(0)
    state, ts = env.reset(generator, 2)
    rewards = []
    for i in range(300):
        action = _uniform(rng, env, 2)
        action[0] = 0.0
        state, ts = env.step(state, action)
        assert n(ts.step_type)[0] != 2
        if i < 200:
            rewards.append(float(ts.reward[1]))
            assert np.isfinite(n(state.body.pos)[1]).all()
            if n(ts.step_type)[1] == 2:
                fresh, _ = env.reset(generator, 2)
                state = tree_select(torch.tensor([False, True]), fresh, state)
    assert 0.35 < float(state.body.pos[0, 0, 2]) < 1.2
    assert 0.3 < float(np.mean(rewards)) < 2.5


def test_ant_terminates_when_unhealthy_and_truncates_at_its_limit():
    env = locomotion.Ant(max_steps=5)
    state, _ = env.reset(torch.Generator().manual_seed(0), 1)
    # The whole body teleported down: the torso sits below the healthy band.
    sunk = state._replace(body=state.body._replace(
        pos=state.body.pos - torch.tensor([0.0, 0.0, 0.5])))
    _, ts = env.step(sunk, torch.zeros((1, 8)))
    assert int(ts.step_type[0]) == 2 and float(ts.discount[0]) == 0.0
    for _ in range(5):
        state, ts = env.step(state, torch.zeros((1, 8)))
    assert int(ts.step_type[0]) == 2 and float(ts.discount[0]) == 1.0
    assert bool(ts.extras["truncation"][0])


PLANAR = {"Hopper": 3, "Walker2d": 6, "HalfCheetah": 6}


@pytest.mark.parametrize("name", list(PLANAR))
def test_planar_oracles(name):
    """tests/test_planar_locomotion.py, batched per robot: env 0 acts at
    random (finite for 60 steps; after 40 its y translation is exactly 0
    and its quaternions stay in the (w, y) plane), env 1 holds zero action
    (Walker2d stands 80 steps above 0.9; Hopper falls within 200)."""
    env = getattr(locomotion, name)()
    assert env._nj == PLANAR[name] and env._obs_dim == 5 + 2 * PLANAR[name]
    state, ts = env.reset(torch.Generator().manual_seed(3), 2)
    rng, fell = np.random.default_rng(3), False
    steps = {"Hopper": 200, "Walker2d": 80, "HalfCheetah": 60}[name]
    for i in range(steps):
        action = _uniform(rng, env, 2)
        action[1] = 0.0
        state, ts = env.step(state, action)
        if i < 60:
            assert np.isfinite(n(ts.observation.agent_view)[0]).all()
            assert np.isfinite(n(ts.reward)[0])
        if i == 39:
            assert float(state.body.pos[0, :, 1].abs().max()) == 0.0
            assert float(state.body.quat[0, :, 1].abs().max()) < 1e-6
            assert float(state.body.quat[0, :, 3].abs().max()) < 1e-6
        if name == "Walker2d":
            assert not bool(ts.last()[1])
        fell |= bool(ts.last()[1])
        if name == "Hopper" and fell:
            break
    if name == "Walker2d":
        assert float(state.body.pos[1, 0, 2]) > 0.9
    if name == "Hopper":
        assert fell, "hopper never terminated under zero action"


def test_halfcheetah_never_terminates_only_truncates():
    env = locomotion.HalfCheetah(max_steps=50)
    state, _ = env.reset(torch.Generator().manual_seed(0), 1)
    rng = np.random.default_rng(0)
    for i in range(50):
        state, ts = env.step(state, _uniform(rng, env, 1))
        if i < 49:
            assert not bool(ts.last()[0])
    assert bool(ts.last()[0]) and bool(ts.extras["truncation"][0])
    assert float(ts.discount[0]) == 1.0
