"""The port's MinAtar games (stoix_tpu_torch/envs/minatar.py) against the
JAX package's: both step the same actions for 200 steps across episode ends,
each ended env reset on both sides, the port's Breakout from the serve coins
JAX's resets drew (read from JAX's reset state); Asterix, Freeway and
SpaceInvaders draw nothing. Boards, rewards, discounts, step types and
truncations are exact. Then the JAX package's behaviour oracles
(tests/test_minatar.py) on the port: a lost ball terminates, gold scores, a
crossing scores, shooting scores, an invasion terminates.
"""

import numpy as np
import pytest
import torch

from stoix_tpu.envs import minatar as jminatar
from stoix_tpu_torch.envs import minatar
from torch_parity import env_lockstep, n

GAMES = {
    # name: (num_actions, the serve coins of a JAX reset state or None, kwargs)
    "Breakout": (3, lambda s: np.asarray(s.ball_c) == 0, {}),
    "Asterix": (5, None, {}),
    # Freeway never terminates and SpaceInvaders rarely does under random
    # play: a short step limit puts truncations among the 200 steps.
    "Freeway": (3, None, {"max_steps": 60}),
    "SpaceInvaders": (4, None, {"max_steps": 60}),
}


@pytest.mark.parametrize("name", list(GAMES))
def test_game_matches_jax_across_episode_ends(name):
    num_actions, draws_of, kwargs = GAMES[name]
    ends = env_lockstep(getattr(jminatar, name)(**kwargs), getattr(minatar, name)(**kwargs),
                        draws_of, num_actions, steps=200, num_envs=8, seed=3)
    assert ends > 0, f"no {name} episode ended in 200 steps"


def _run(env, actions, steps, num_envs=1):
    """Rewards and LAST flags of `steps` steps of `actions(step)`."""
    state, ts = env.reset(torch.Generator().manual_seed(0), num_envs)
    rewards, last, discounts = [], [], []
    for i in range(steps):
        state, ts = env.step(state, torch.full((num_envs,), actions(i, state), dtype=torch.int64))
        rewards.append(n(ts.reward))
        last.append(n(ts.last()))
        discounts.append(n(ts.discount))
    return np.stack(rewards), np.stack(last), np.stack(discounts)


def test_breakout_lost_ball_terminates():
    env = minatar.Breakout()
    # Hold the paddle at the far side of the serve: the ball must be lost.
    _, last, discounts = _run(env, lambda i, s: 0 if int(s.dc[0]) == 1 else 2, 20)
    first = int(np.argmax(last[:, 0]))
    assert last[first, 0] and discounts[first, 0] == 0.0


def test_asterix_gold_scores_and_standing_still_dies():
    env = minatar.Asterix()
    # The first spawn is gold on row 1 moving right: walk up into its path.
    rewards, _, _ = _run(env, lambda i, s: 2 if i < 4 else 0, 34)
    assert rewards.sum() >= 1.0
    _, last, discounts = _run(env, lambda i, s: 0, 200)
    assert (last[:, 0] & (discounts[:, 0] == 0.0)).any()


def test_freeway_crossing_scores():
    rewards, _, _ = _run(minatar.Freeway(), lambda i, s: 1, 200)
    assert rewards.sum() >= 1.0


def test_space_invaders_shooting_scores_and_invasion_terminates():
    env = minatar.SpaceInvaders()
    rewards, _, _ = _run(env, lambda i, s: 3, 60)
    assert rewards.sum() >= 1.0
    _, last, discounts = _run(env, lambda i, s: 0, 400)
    assert (last[:, 0] & (discounts[:, 0] == 0.0)).any()


def test_stepping_past_the_end_drops_off_board_writes():
    """The evaluator steps finished envs and discards the result: a Breakout
    ball past the paddle row leaves the board without an index error, as
    XLA drops the out-of-range write."""
    env = minatar.Breakout()
    state, _ = env.reset(torch.Generator().manual_seed(0), 2)
    away = torch.where(state.dc == 1, 0, 2)
    for _ in range(30):
        state, ts = env.step(state, away)
    assert int(state.ball_r.max()) >= 10
    assert n(ts.observation.agent_view)[..., 1].sum() == 0.0
