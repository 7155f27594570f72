"""The port's 84x84x4 pixel Breakout (stoix_tpu_torch/envs/breakout_pixel.py)
against the JAX package's: both step the same actions for 200 steps across
episode ends, each ended env served on both sides from the serve index
JAX's reset drew (read from JAX's reset state). Frames, rewards, discounts,
step types and truncations are exact (float32 gray levels included). Then
the JAX package's behaviour oracles (tests/test_breakout_pixel.py) on the
port: the observation contract, the frame stack shifting, a lost ball
terminating.
"""

import numpy as np
import torch

from stoix_tpu.envs import breakout_pixel as jbreakout_pixel
from stoix_tpu_torch.envs import breakout_pixel
from torch_parity import env_lockstep, n


def test_pixel_breakout_matches_jax_across_episode_ends():
    # A step limit of 100 adds truncations to the terminations.
    ends = env_lockstep(jbreakout_pixel.BreakoutPixel(max_steps=100),
                        breakout_pixel.BreakoutPixel(max_steps=100),
                        lambda s: np.asarray(s.serves) - 1, 3, steps=200, num_envs=8, seed=1)
    assert ends > 0


def test_serves_from_given_indices_match_jax_serve():
    import jax.numpy as jnp

    serves = np.arange(0, 134, 7)
    env = breakout_pixel.BreakoutPixel()
    _, ts = env.reset_from_draws(torch.from_numpy(serves), torch.Generator())
    jenv = jbreakout_pixel.BreakoutPixel()
    for i, k in enumerate(serves):
        want = jenv._serve(None, jnp.asarray(k, jnp.int32)).frames
        np.testing.assert_array_equal(n(ts.observation.agent_view)[i], np.asarray(want))


def test_observation_contract_and_frame_stack():
    env = breakout_pixel.BreakoutPixel()
    state, ts = env.reset(torch.Generator().manual_seed(0), 4)
    view = n(ts.observation.agent_view)
    assert view.shape == (4, 84, 84, 4) and view.dtype == np.float32
    assert view.min() >= 0.0 and view.max() <= 1.0
    for s in range(3):  # the reset repeats the serve frame
        np.testing.assert_array_equal(view[..., s], view[..., s + 1])
    newest = view[0, :, :, -1]
    assert (newest == 1.0).sum() >= 1  # the ball
    assert (np.abs(newest - 200.0 / 255.0) < 1e-3).sum() > 0  # the paddle
    assert (newest > 0.4).sum() > 200  # the brick band
    state, ts = env.step(state, torch.ones((4,), dtype=torch.int64))
    after = n(ts.observation.agent_view)
    for s in range(3):  # one step shifts the stack
        np.testing.assert_array_equal(after[..., s], view[..., s + 1])
    assert not np.array_equal(after[..., 3], view[..., 3])


def test_lost_ball_terminates():
    env = breakout_pixel.BreakoutPixel()
    state, _ = env.reset_from_draws(torch.tensor([0, 1]), torch.Generator())
    # Park the paddle at the wall away from the ball's landing column.
    for _ in range(60):
        away = torch.where(state.ball_c < 42, 2, 0)
        state, ts = env.step(state, away)
        if bool(ts.last().all()):
            break
    assert bool(ts.last().all()) and n(ts.discount).tolist() == [0.0, 0.0]
