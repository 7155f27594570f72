"""Breakout-atari as a batched tensor env (counterpart of
stoix_tpu/envs/breakout_pixel.py): the full-resolution pixel game, rendered
on the device as masks composed over `[N, 84, 84]`.

Game: an 84x84 playfield; a 12x2 paddle at row 80 moving 3 px a step (3
actions); a 2x2 ball at 2 px a step whose bounce off the paddle aims by the
hit offset; a 6x14 wall of 6x3 px bricks on rows 18..35 with a 1-px right
gutter, shaded by row, +1 a brick, refreshed when cleared; losing the ball
below the paddle terminates. The observation is a stack of 4 grayscale
frames in [0, 1], float32, oldest to newest (the EnvPool-Atari layout); a
reset repeats the serve frame 4 times.

The only draw is the serve index at reset, uniform on [0, 134).
`reset_from_draws(serves, generator)` serves from given indices (the JAX
package's `_serve(key, serves)`), so the tests can feed JAX's draws.
"""

from __future__ import annotations

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

_PIX = 84
_STACK = 4
_PAD_W = 12
_PAD_H = 2
_PAD_ROW = 80
_PAD_SPEED = 3
_BALL = 2
_BRICK_W = 6
_BRICK_H = 3
_BRICK_COLS = _PIX // _BRICK_W  # 14
_BRICK_ROWS = 6
_BRICK_TOP = 18
_SERVE_RANGE = _PIX - 16 - _BALL + 1  # 67


class BreakoutPixelState(NamedTuple):
    generator: torch.Generator
    ball_r: torch.Tensor  # [N] int64, top-left of the 2x2 sprite
    ball_c: torch.Tensor
    dr: torch.Tensor  # {-2, +2}
    dc: torch.Tensor  # {-2, -1, +1, +2}
    paddle: torch.Tensor  # leftmost paddle column
    serves: torch.Tensor  # episodes served
    bricks: torch.Tensor  # [N, 6, 14] int64 in {0, 1}
    frames: torch.Tensor  # [N, 84, 84, 4] float32, oldest -> newest
    step_count: torch.Tensor  # [N] int32


def render(ball_r: torch.Tensor, ball_c: torch.Tensor, paddle: torch.Tensor,
           bricks: torch.Tensor) -> torch.Tensor:
    """One [N, 84, 84] grayscale frame a env: the wall, then the paddle, then
    the ball on top. The gray levels are uint8 values times float32(1/255),
    one rounding, as the JAX package forms them."""
    device = ball_r.device
    r = torch.arange(_PIX, device=device)[:, None]
    c = torch.arange(_PIX, device=device)[None, :]
    inv = torch.tensor(1.0 / 255.0, dtype=torch.float32, device=device)
    # Brick wall: a row-graded shade and a 1-px right gutter per brick.
    band_row = torch.clamp((r - _BRICK_TOP) // _BRICK_H, 0, _BRICK_ROWS - 1)
    in_band = (r >= _BRICK_TOP) & (r < _BRICK_TOP + _BRICK_ROWS * _BRICK_H)
    alive = bricks[:, band_row, c // _BRICK_W] == 1
    gutter = (c % _BRICK_W) == (_BRICK_W - 1)
    shade = (110.0 + 20.0 * band_row.to(torch.float32)) * inv
    frame = torch.where(in_band & alive & ~gutter, shade, 0.0)
    ball_r, ball_c, paddle = (x[:, None, None] for x in (ball_r, ball_c, paddle))
    pad = (r >= _PAD_ROW) & (r < _PAD_ROW + _PAD_H) & (c >= paddle) & (c < paddle + _PAD_W)
    frame = torch.where(pad, 200.0 * inv, frame)
    ball = (r >= ball_r) & (r < ball_r + _BALL) & (c >= ball_c) & (c < ball_c + _BALL)
    return torch.where(ball, 1.0, frame)


class BreakoutPixel(Environment):
    """Breakout on 84x84x4 frames (see the module docstring)."""

    def __init__(self, max_steps: int = 500):
        self._max_steps = int(max_steps)

    def observation_space(self) -> Observation:
        return Observation(
            agent_view=spaces.Array((_PIX, _PIX, _STACK), torch.float32),
            action_mask=spaces.Array((3,), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(3)

    def _observe(self, state: BreakoutPixelState) -> Observation:
        return Observation(
            agent_view=state.frames,
            action_mask=torch.ones((state.frames.shape[0], 3), dtype=torch.float32,
                                   device=state.frames.device),
            step_count=state.step_count,
        )

    def reset(self, generator: torch.Generator, num_envs: int
              ) -> Tuple[BreakoutPixelState, TimeStep]:
        serves = torch.randint(0, 2 * _SERVE_RANGE, (num_envs,), generator=generator,
                               device=generator.device)
        return self.reset_from_draws(serves, generator)

    def reset_from_draws(self, serves: torch.Tensor, generator: torch.Generator
                         ) -> Tuple[BreakoutPixelState, TimeStep]:
        """Serve every env from its serve index ([N] integers): the column
        walks the 67-wide range by a coprime stride, the direction alternates."""
        k = serves.to(device=generator.device, dtype=torch.int64)
        n, device = k.shape[0], k.device
        ball_r = torch.full((n,), _BRICK_TOP + _BRICK_ROWS * _BRICK_H + 4, dtype=torch.int64,
                            device=device)
        ball_c = 8 + (k * 37) % _SERVE_RANGE
        dc = torch.where(k % 2 == 0, 1, -1)
        paddle = torch.full((n,), (_PIX - _PAD_W) // 2, dtype=torch.int64, device=device)
        bricks = torch.ones((n, _BRICK_ROWS, _BRICK_COLS), dtype=torch.int64, device=device)
        frame = render(ball_r, ball_c, paddle, bricks)
        state = BreakoutPixelState(
            generator, ball_r, ball_c, torch.full_like(ball_r, 2), dc, paddle, k + 1, bricks,
            frame[..., None].repeat(1, 1, 1, _STACK),
            torch.zeros((n,), dtype=torch.int32, device=device),
        )
        ts = restart(self._observe(state), n, device)
        ts.extras["truncation"] = torch.zeros((n,), dtype=torch.bool, device=device)
        return state, ts

    def step(self, state: BreakoutPixelState, action: torch.Tensor
             ) -> Tuple[BreakoutPixelState, TimeStep]:
        paddle = torch.clamp(state.paddle + (action.to(torch.int64) - 1) * _PAD_SPEED, 0,
                             _PIX - _PAD_W)
        nr = state.ball_r + state.dr
        nc = state.ball_c + state.dc
        dr, dc = state.dr, state.dc
        # Side walls (a reflective fold keeps the motion exact at any speed).
        dc = torch.where(nc < 0, -dc, dc)
        nc = torch.where(nc < 0, -nc, nc)
        over = nc > _PIX - _BALL
        dc = torch.where(over, -dc, dc)
        nc = torch.where(over, 2 * (_PIX - _BALL) - nc, nc)
        # Ceiling.
        ceil = nr < 0
        dr = torch.where(ceil, 2, dr)
        nr = torch.where(ceil, -nr, nr)

        # Brick band: the ball's center cell against the brick grid.
        cr = nr + _BALL // 2
        cc = nc + _BALL // 2
        in_band = (cr >= _BRICK_TOP) & (cr < _BRICK_TOP + _BRICK_ROWS * _BRICK_H)
        br = torch.clamp((cr - _BRICK_TOP) // _BRICK_H, 0, _BRICK_ROWS - 1)
        bc = torch.clamp(cc // _BRICK_W, max=_BRICK_COLS - 1)
        env = torch.arange(nr.shape[0], device=nr.device)
        hit = in_band & (state.bricks[env, br, bc] == 1)
        bricks = state.bricks.clone()
        bricks[env, br, bc] = torch.where(hit, 0, state.bricks[env, br, bc])
        reward = hit.to(torch.float32)
        dr = torch.where(hit, -dr, dr)
        nr = torch.where(hit, state.ball_r, nr)
        # Wall cleared -> refresh (play continues).
        bricks = torch.where((bricks == 1).any(2).any(1)[:, None, None], bricks, 1)

        # Paddle-plane crossing (only tested outside the brick band).
        crossing = (~in_band & (dr > 0) & (nr + _BALL > _PAD_ROW)
                    & (state.ball_r + _BALL <= _PAD_ROW))
        caught = crossing & (cc >= paddle) & (cc < paddle + _PAD_W)
        dr = torch.where(caught, -2, dr)
        nr = torch.where(caught, _PAD_ROW - _BALL, nr)
        # Aim by the hit offset: the outer thirds send the ball out steeply.
        off = cc - paddle
        aimed_dc = torch.where(off < _PAD_W // 3, -2,
                               torch.where(off >= 2 * (_PAD_W // 3), 2,
                                           torch.where(dc >= 0, 1, -1)))
        dc = torch.where(caught, aimed_dc, dc)
        # The ball lost below the paddle.
        terminated = ~in_band & ~crossing & (nr >= _PIX - _BALL)

        frame = render(nr, nc, paddle, bricks)
        frames = torch.cat([state.frames[..., 1:], frame[..., None]], dim=-1)
        next_state = BreakoutPixelState(state.generator, nr, nc, dr, dc, paddle, state.serves,
                                        bricks, frames, state.step_count + 1)
        obs = self._observe(next_state)
        truncated = (next_state.step_count >= self._max_steps) & ~terminated
        ts = select_step(
            terminated,
            termination(reward, obs),
            select_step(truncated, truncation(reward, obs), transition(reward, obs)),
        )
        ts.extras["truncation"] = truncated
        return next_state, ts
