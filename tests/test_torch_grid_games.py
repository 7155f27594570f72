"""The port's grid games (stoix_tpu_torch/envs/{snake,game2048,doorkey}.py)
against the JAX package's, on the CPU:

1. Snake (6x6), 2048 and DoorKey (6x6) each step the same actions for 200
   steps across episode ends beside their JAX twins (`jax.vmap`, `jax.jit`),
   every ended env reset on both sides. The port is fed the draws JAX makes:
   its reset draws rebuilt from the reset keys (Snake's head cell and fruit
   Gumbel noise, 2048's two spawns' Gumbel noise and uniforms, DoorKey's
   seven draws) and, where the env draws inside its step (Snake's fruit,
   2048's spawn), the step's draws rebuilt from the key in JAX's state.
   Observations, action masks, rewards, discounts, step types and
   truncations are exact.
2. The JAX package's oracles (tests/test_snake.py, tests/test_game2048.py,
   tests/test_doorkey.py) on the port, and DoorKey's scripted solve against
   JAX's (its shaped reward, 1 - 0.9 t / max_steps, as XLA rounds it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.envs import doorkey as jax_doorkey, game2048 as jax_game2048, snake as jax_snake
from stoix_tpu_torch import envs
from stoix_tpu_torch.envs import doorkey, game2048, snake
from torch_parity import env_lockstep, n, t

# ------------------------------------------------------------ JAX's draws


def snake_reset_draws(cells):
    def one(key):
        _, k_pos, k_fruit = jax.random.split(key, 3)
        return jax.random.randint(k_pos, (), 0, cells), jax.random.gumbel(k_fruit, (cells,))

    draws = jax.jit(jax.vmap(one))
    return lambda keys: tuple(np.asarray(x) for x in draws(keys))


def snake_step_draws(cells):
    draws = jax.jit(jax.vmap(lambda k: jax.random.gumbel(jax.random.split(k)[1], (cells,))))
    return lambda state: np.asarray(draws(state.key))


def _spawn_draws(key):
    k_cell, k_val = jax.random.split(key)
    return jax.random.gumbel(k_cell, (16,)), jax.random.uniform(k_val)


def game2048_reset_draws(keys):
    def one(key):
        _, k1, k2 = jax.random.split(key, 3)
        (g1, u1), (g2, u2) = _spawn_draws(k1), _spawn_draws(k2)
        return jnp.stack([g1, g2]), jnp.stack([u1, u2])

    return tuple(np.asarray(x) for x in jax.jit(jax.vmap(one))(keys))


_GAME2048_STEP = jax.jit(jax.vmap(lambda k: _spawn_draws(jax.random.split(k)[1])))


def game2048_step_draws(state):
    return tuple(np.asarray(x) for x in _GAME2048_STEP(state.key))


def doorkey_reset_draws(size):
    def one(key):
        _, k_wall, k_door, k_agent, k_key, k_goal, k_dir = jax.random.split(key, 7)
        return (jax.random.randint(k_wall, (), 2, size - 2),
                jax.random.randint(k_door, (), 1, size - 1),
                *(jax.random.gumbel(k, (size * size,)) for k in (k_agent, k_key, k_goal)),
                jax.random.randint(k_dir, (), 0, 4))

    draws = jax.jit(jax.vmap(one))
    return lambda keys: doorkey.DoorKeyDraws(*(np.asarray(x) for x in draws(keys)))


# ------------------------------------------------------------------ lockstep


def test_snake_matches_jax_across_episode_ends():
    ends = env_lockstep(jax_snake.Snake(6, 6, max_steps=60), snake.Snake(6, 6, max_steps=60),
                        None, 4, steps=200, num_envs=8, seed=1,
                        reset_draws=snake_reset_draws(36), step_draws=snake_step_draws(36))
    assert ends > 8


def test_game2048_matches_jax_across_episode_ends():
    # A short step limit puts truncations among the 200 steps; the masked
    # actions (invalid moves) stay in, so no-op steps are held too.
    ends = env_lockstep(jax_game2048.Game2048(max_steps=80), game2048.Game2048(max_steps=80),
                        None, 4, steps=200, num_envs=8, seed=2,
                        reset_draws=game2048_reset_draws, step_draws=game2048_step_draws)
    assert ends >= 16


def test_doorkey_matches_jax_across_episode_ends():
    ends = env_lockstep(jax_doorkey.DoorKey(6, max_steps=40), doorkey.DoorKey(6, max_steps=40),
                        None, 5, steps=200, num_envs=8, seed=3, reset_draws=doorkey_reset_draws(6))
    assert ends >= 40


@pytest.mark.parametrize("scenario", ["Snake-v1", "Game2048-v1", "DoorKey-v0"])
def test_scenario_is_registered_with_the_jax_spaces(scenario):
    from stoix_tpu.envs.registry import make_single as jax_make_single

    env, jenv = envs.make_single(scenario), jax_make_single(scenario)
    assert env.observation_space().agent_view.shape == jenv.observation_space().agent_view.shape
    assert env.num_actions == jenv.num_actions


# ------------------------------------------------------------------ Snake oracles


def _snake_state(env, body_rows, heading=1, fruit=(0, 0)):
    body = torch.zeros((1, env._max_len, 2), dtype=torch.int64)
    for i, pos in enumerate(body_rows):
        body[0, i] = torch.tensor(pos)
    return snake.SnakeState(torch.Generator().manual_seed(0), body,
                            torch.tensor([len(body_rows)]), torch.tensor([heading]),
                            torch.tensor([fruit]), torch.zeros((1,), dtype=torch.int32))


def test_snake_reset_channels():
    env = snake.Snake()
    _, ts = env.reset(torch.Generator().manual_seed(0), 4)
    grid = n(ts.observation.agent_view)
    assert grid.shape == (4, 12, 12, 5)
    assert (grid[..., 1].sum(axis=(1, 2)) == 1.0).all()  # one head
    assert (grid[..., 3].sum(axis=(1, 2)) == 1.0).all()  # one fruit
    assert (grid[..., 0].sum(axis=(1, 2)) == 0.0).all()  # no body beyond the head
    assert not (grid[..., 1] * grid[..., 3]).any()  # the fruit is not under the head


def test_snake_moves_eats_grows_and_collides():
    env = snake.Snake()
    state, ts = env.step(_snake_state(env, [(5, 5)], fruit=(5, 6)), torch.tensor([1]))
    assert float(ts.reward[0]) == 1.0 and int(state.length[0]) == 2 and int(ts.step_type[0]) == 1
    assert n(state.body)[0, :2].tolist() == [[5, 6], [5, 5]]
    assert n(state.fruit)[0].tolist() not in ([5, 6], [5, 5])
    # Off the board: terminated with reward 0.
    _, ts = env.step(_snake_state(env, [(0, 5)], fruit=(8, 8)), torch.tensor([0]))
    assert int(ts.step_type[0]) == 2 and float(ts.discount[0]) == 0.0 and float(ts.reward[0]) == 0
    # A 2x2 loop: onto the vacating tail is legal, onto the neck is death.
    loop = [(5, 5), (5, 6), (6, 6), (6, 5)]
    _, ts = env.step(_snake_state(env, loop, heading=3), torch.tensor([2]))
    assert int(ts.step_type[0]) == 1
    _, ts = env.step(_snake_state(env, loop, heading=3), torch.tensor([1]))
    assert int(ts.step_type[0]) == 2 and float(ts.discount[0]) == 0.0
    # Heading down at length 2: the reverse (up) is masked.
    _, ts = env.step(_snake_state(env, [(5, 5), (5, 4)]), torch.tensor([2]))
    assert n(ts.observation.action_mask)[0, 0] == 0.0 and n(ts.observation.action_mask)[0, 2] == 1


def test_snake_fruit_never_on_body_and_random_play_scores_little():
    env = snake.Snake(5, 5, max_steps=200)
    generator, rng = torch.Generator().manual_seed(3), np.random.default_rng(4)
    state, ts = env.reset(generator, 16)
    for _ in range(100):
        mask = n(ts.observation.action_mask)
        action = torch.from_numpy(np.array([rng.choice(np.flatnonzero(m)) for m in mask]))
        state, ts = env.step(state, action)
        live = torch.arange(env._max_len)[None] < state.length[:, None]
        on_body = (live & (state.body == state.fruit[:, None]).all(-1)).any(-1)
        ended = ts.last()
        assert not bool((on_body & ~ended).any())
    big = snake.Snake()
    state, ts = big.reset(generator, 8)
    totals, done = np.zeros(8), np.zeros(8, bool)
    for _ in range(500):
        mask = n(ts.observation.action_mask)
        action = torch.from_numpy(np.array([rng.choice(np.flatnonzero(m)) for m in mask]))
        state, ts = big.step(state, action)
        totals += np.where(done, 0.0, n(ts.reward))
        done |= n(ts.step_type) == 2
        if done.all():
            break
    assert 0.0 <= totals.mean() < 5.0


# ------------------------------------------------------------------ 2048 oracles


@pytest.mark.parametrize("row,expected", [
    ([0, 1, 0, 2], [1, 2, 0, 0]), ([0, 0, 0, 0], [0, 0, 0, 0]), ([3, 0, 0, 1], [3, 1, 0, 0]),
    ([1, 2, 3, 4], [1, 2, 3, 4])])
def test_2048_compress_preserves_order(row, expected):
    assert n(game2048.compress_rows(torch.tensor([row]))).tolist() == [expected]


@pytest.mark.parametrize("row,expected,score", [
    ([1, 1, 0, 0], [2, 0, 0, 0], 4.0), ([1, 1, 1, 1], [2, 2, 0, 0], 8.0),
    ([2, 2, 2, 0], [3, 2, 0, 0], 8.0), ([1, 2, 2, 1], [1, 3, 1, 0], 8.0),
    ([2, 2, 1, 1], [3, 2, 0, 0], 12.0), ([1, 2, 1, 2], [1, 2, 1, 2], 0.0),
    ([0, 0, 0, 0], [0, 0, 0, 0], 0.0)])
def test_2048_merge_semantics(row, expected, score):
    merged, got = game2048.merge_rows(torch.tensor([row]))
    assert n(merged).tolist() == [expected] and float(got[0]) == score
    # and as the JAX package merges it
    want, want_score = jax_game2048._merge_row(jnp.asarray(row, jnp.int32))
    assert np.asarray(want).tolist() == expected and float(want_score) == score


def test_2048_move_directions_match_jax():
    rng = np.random.default_rng(0)
    boards = rng.integers(0, 4, size=(64, 4, 4)).astype(np.int32)
    want = jax.jit(jax.vmap(jax_game2048._all_moves))(jnp.asarray(boards))
    got = game2048.all_moves(t(boards).long())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    corners = torch.tensor([[[1, 0, 0, 1], [0, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 1]]])
    moved, scores, _ = game2048.all_moves(corners)
    assert n(moved)[0, 3, 0].tolist() == [2, 0, 0, 0] and float(scores[0, 3]) == 8.0  # left
    assert n(moved)[0, 0, 0].tolist() == [2, 0, 0, 2] and float(scores[0, 0]) == 8.0  # up
    assert n(moved)[0, 2, 3].tolist() == [2, 0, 0, 2]  # down
    assert n(moved)[0, 1, 0].tolist() == [0, 0, 0, 2]  # right


def _2048_state(env, board):
    return env._make_state(torch.Generator().manual_seed(0), torch.tensor([board]),
                           torch.zeros((1,), dtype=torch.int32))


def test_2048_masks_terminal_invalid_and_valid_moves():
    env = game2048.Game2048()
    dead = [[1, 2, 1, 2], [2, 1, 2, 1], [1, 2, 1, 2], [2, 1, 2, 1]]
    state = _2048_state(env, dead)
    assert not bool(state.move_changed.any())
    _, ts = env.step(state, torch.tensor([3]))
    assert bool(ts.last()[0]) and float(ts.discount[0]) == 0.0 and float(ts.reward[0]) == 0.0
    # LEFT changes nothing here: no spawn, no reward, not the end.
    board = [[1, 0, 0, 0], [2, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]
    next_state, ts = env.step(_2048_state(env, board), torch.tensor([3]))
    assert n(next_state.board)[0].tolist() == board
    assert float(ts.reward[0]) == 0.0 and not bool(ts.last()[0])
    # A merge scores 4 and spawns one tile.
    board = [[1, 0, 0, 1], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]
    next_state, ts = env.step(_2048_state(env, board), torch.tensor([3]))
    assert float(ts.reward[0]) == 4.0
    assert int((next_state.board > 0).sum()) == 2 and int(next_state.board[0, 0, 0]) == 2


def test_2048_random_play_scores_and_shapes():
    env = game2048.Game2048(max_steps=300)
    generator, rng = torch.Generator().manual_seed(0), np.random.default_rng(0)
    state, ts = env.reset(generator, 8)
    assert ts.observation.agent_view.shape == (8, 4, 4)
    assert ts.observation.action_mask.shape == (8, 4)
    total = np.zeros(8)
    for _ in range(300):
        mask = n(ts.observation.action_mask)
        action = torch.from_numpy(np.array([rng.choice(np.flatnonzero(m)) if m.any() else 0
                                            for m in mask]))
        state, ts = env.step(state, action)
        total += n(ts.reward)
        assert bool((state.board >= 0).all())
    assert (total > 0).all()


# ------------------------------------------------------------------ DoorKey oracles


def _doorkey_state(agent=(2, 1), direction=1, has_key=False, door_open=False, key=(3, 1),
                   door=(2, 3), goal=(2, 4), wall_col=3):
    long = lambda x: torch.tensor([x], dtype=torch.int64)  # noqa: E731
    return doorkey.DoorKeyState(torch.Generator(), long(agent), long(direction),
                                torch.tensor([has_key]), torch.tensor([door_open]), long(key),
                                long(door), long(goal), long(wall_col),
                                torch.zeros((1,), dtype=torch.int32))


def _jax_doorkey_state(**kwargs):
    defaults = dict(agent=(2, 1), direction=1, has_key=False, door_open=False, key=(3, 1),
                    door=(2, 3), goal=(2, 4), wall_col=3)
    defaults.update(kwargs)
    i32 = lambda x: jnp.asarray(x, jnp.int32)  # noqa: E731
    return jax_doorkey.DoorKeyState(
        jax.random.PRNGKey(0), i32(defaults["agent"]), i32(defaults["direction"]),
        jnp.asarray(defaults["has_key"]), jnp.asarray(defaults["door_open"]),
        i32(defaults["key"]), i32(defaults["door"]), i32(defaults["goal"]),
        i32(defaults["wall_col"]), jnp.zeros((), jnp.int32))


def test_doorkey_reset_layout_invariants():
    env = doorkey.DoorKey(size=6)
    state, ts = env.reset(torch.Generator().manual_seed(0), 64)
    wall = n(state.wall_col)
    assert ((wall >= 2) & (wall <= 3)).all()
    assert (n(state.agent_rc)[:, 1] < wall).all() and (n(state.key_rc)[:, 1] < wall).all()
    assert (n(state.goal_rc)[:, 1] > wall).all() and (n(state.door_rc)[:, 1] == wall).all()
    assert (n(state.agent_rc) != n(state.key_rc)).any(axis=1).all()
    assert ts.observation.agent_view.shape == (64, 5, 5, 6)


def test_doorkey_turns_blocking_and_scripted_solve_match_jax():
    env, jenv = doorkey.DoorKey(size=6), jax_doorkey.DoorKey(size=6)
    jstep = jax.jit(jenv.step)
    state = _doorkey_state(agent=(2, 2), direction=1)
    assert n(env.step(state, torch.tensor([2]))[0].agent_rc)[0].tolist() == [2, 2]  # the door
    assert int(env.step(state, torch.tensor([1]))[0].agent_dir[0]) == 2
    assert int(env.step(state, torch.tensor([0]))[0].agent_dir[0]) == 0
    assert not bool(env.step(state, torch.tensor([4]))[0].door_open[0])  # no key: stays shut
    # Pick up the key below, open the door, walk through it to the goal.
    state = _doorkey_state(agent=(2, 1), direction=2, key=(3, 1))
    jstate = _jax_doorkey_state(agent=(2, 1), direction=2, key=(3, 1))
    script = [3, 0, 2, 4, 2, 2]  # pickup, turn east, step, toggle the door, through, goal
    for action in script:
        state, ts = env.step(state, torch.tensor([action]))
        jstate, jts = jstep(jstate, jnp.asarray(action))
        np.testing.assert_array_equal(n(ts.observation.agent_view)[0],
                                      np.asarray(jts.observation.agent_view))
        np.testing.assert_array_equal(n(ts.reward)[0], np.asarray(jts.reward))
        assert int(ts.step_type[0]) == int(jts.step_type)
    assert bool(state.has_key[0]) and bool(state.door_open[0]) and int(state.key_rc[0, 0]) == -1
    assert bool(ts.last()[0]) and float(ts.discount[0]) == 0.0 and float(ts.reward[0]) > 0.8


def test_doorkey_egocentric_view_rotates_with_heading():
    env = doorkey.DoorKey(size=6)
    ahead = (3, 2)  # one cell up from the agent at the bottom centre (4, 2)
    view = n(env._observe(_doorkey_state(agent=(2, 2), direction=1)).agent_view)[0]
    assert view[ahead][1] == 1.0  # facing east: the closed door straight ahead
    view = n(env._observe(_doorkey_state(agent=(2, 2), direction=0)).agent_view)[0]
    assert view[3, 3, 0] + view[3, 3, 1] > 0.0  # facing north: the wall to the right
    view = n(env._observe(_doorkey_state(agent=(2, 2), direction=0, has_key=True)).agent_view)[0]
    assert view[..., 5].min() == 1.0
    # Every heading and position against the JAX view.
    jobs = jax.jit(jax_doorkey.DoorKey(size=6)._observe)
    for direction in range(4):
        for agent in ((1, 1), (2, 2), (4, 1), (1, 4), (4, 4)):
            got = n(env._observe(_doorkey_state(agent=agent, direction=direction)).agent_view)
            want = jobs(_jax_doorkey_state(agent=agent, direction=direction)).agent_view
            np.testing.assert_array_equal(got[0], np.asarray(want))


def test_doorkey_truncates_and_rejects_a_small_board():
    env = doorkey.DoorKey(size=6, max_steps=10)
    state, ts = env.reset(torch.Generator().manual_seed(0), 4)
    for _ in range(10):
        state, ts = env.step(state, torch.zeros((4,), dtype=torch.int64))  # spin in place
    assert bool(ts.last().all()) and bool(ts.extras["truncation"].all())
    assert bool((ts.discount == 1.0).all())
    with pytest.raises(ValueError, match="size >= 5"):
        doorkey.DoorKey(size=4)
