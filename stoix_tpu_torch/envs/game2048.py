"""2048 as a batched tensor env (counterpart of stoix_tpu/envs/game2048.py).

The board is a 4x4 grid of tile exponents (0 empty, k the tile 2^k). A move
slides every row toward one side, merges equal neighbours leftmost-first
(each tile at most once a move) and scores the created tiles' values; a
tile (2 with probability 0.9, else 4) spawns in a uniform empty cell after
every valid move; an invalid move changes nothing. The episode ends when no
move changes the board. All four candidate moves of every env are computed
at once, as the JAX package's state keeps them (the action mask and the
next step's move).

A spawn draws Gumbel noise over the 16 cells and a uniform for the tile.
`reset_from_draws((gumbel [E, 2, 16], uniform [E, 2]), generator)` and
`step_from_draws(state, action, (gumbel [E, 16], uniform [E]))` take them
given, so the tests can feed the JAX package's; `reset` and `step` draw
them from the env's generator.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from stoix_tpu_torch.envs import spaces
from stoix_tpu_torch.envs.core import Environment
from stoix_tpu_torch.envs.snake import gumbel, masked_argmax
from stoix_tpu_torch.envs.types import (
    Observation,
    TimeStep,
    restart,
    select_step,
    termination,
    transition,
    truncation,
)

_SIZE = 4


def compress_rows(rows: torch.Tensor) -> torch.Tensor:
    """Slide non-zero tiles left, keeping their order: [..., 4] -> [..., 4]."""
    perm = torch.sort((rows == 0).to(torch.int8), dim=-1, stable=True).indices
    return torch.gather(rows, -1, perm)


def merge_rows(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge COMPRESSED rows [..., 4] leftmost-first: (new rows, score [...])."""
    a, b, c, d = rows.unbind(-1)
    zero = torch.zeros_like(a)
    ab = (a > 0) & (a == b)
    # If (a, b) merged the next pair is (c, d); else (b, c), then (c, d) only
    # if (b, c) did not merge.
    bc = ~ab & (b > 0) & (b == c)
    cd = (c > 0) & (c == d) & (ab | ~bc)
    score = (torch.where(ab, 1 << (a + 1), zero) + torch.where(bc, 1 << (b + 1), zero)
             + torch.where(cd, 1 << (c + 1), zero))
    merged = torch.stack([
        torch.where(ab, a + 1, a),
        torch.where(ab, zero, torch.where(bc, b + 1, b)),
        torch.where(bc, zero, torch.where(cd, c + 1, c)),
        torch.where(cd, zero, d),
    ], dim=-1)
    return compress_rows(merged), score.to(torch.float32)


def move_left(boards: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A LEFT move of boards [..., 4, 4]: (boards, score [...])."""
    rows, scores = merge_rows(compress_rows(boards))
    return rows, scores.sum(dim=-1)


def all_moves(board: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All four moves of boards [E, 4, 4] (0 up, 1 right, 2 down, 3 left):
    (boards [E, 4, 4, 4], scores [E, 4], changed [E, 4])."""
    # Each move as a LEFT move of the board turned so that side is left.
    turned = torch.stack([board.transpose(-1, -2), board.flip(-1),
                          board.transpose(-1, -2).flip(-1), board], dim=1)
    moved, scores = move_left(turned)
    boards = torch.stack([moved[:, 0].transpose(-1, -2), moved[:, 1].flip(-1),
                          moved[:, 2].flip(-1).transpose(-1, -2), moved[:, 3]], dim=1)
    changed = (boards != board[:, None]).flatten(2).any(dim=-1)
    return boards, scores, changed


def spawn(board: torch.Tensor, noise: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
    """Place a 2 (uniform < 0.9) or a 4 in the empty cell the Gumbel noise
    [E, 16] picks, on boards [E, 4, 4]."""
    flat = board.reshape(board.shape[0], -1)
    idx = masked_argmax(noise, flat == 0)
    value = torch.where(uniform < 0.9, 1, 2).to(flat.dtype)
    return flat.scatter(1, idx[:, None], value[:, None]).reshape(board.shape)


class Game2048State(NamedTuple):
    generator: torch.Generator
    board: torch.Tensor  # [E, 4, 4] int64 exponents
    step_count: torch.Tensor  # [E] int32
    move_boards: torch.Tensor  # [E, 4, 4, 4]
    move_scores: torch.Tensor  # [E, 4]
    move_changed: torch.Tensor  # [E, 4] bool


class Game2048(Environment):
    """4x4 2048; reward = value of the tiles a move creates."""

    def __init__(self, max_steps: int = 1000):
        self._max_steps = int(max_steps)

    def observation_space(self) -> Observation:
        return Observation(
            agent_view=spaces.Array((_SIZE, _SIZE), torch.float32),
            action_mask=spaces.Array((4,), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(4)

    def _make_state(self, generator: torch.Generator, board: torch.Tensor,
                    step_count: torch.Tensor) -> Game2048State:
        return Game2048State(generator, board, step_count, *all_moves(board))

    def _observe(self, state: Game2048State) -> Observation:
        return Observation(agent_view=state.board.to(torch.float32),
                           action_mask=state.move_changed.to(torch.float32),
                           step_count=state.step_count)

    def _draws(self, generator: torch.Generator, lead: Tuple[int, ...]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (gumbel(generator, lead + (_SIZE * _SIZE,)),
                torch.rand(lead, generator=generator, device=generator.device))

    def reset(self, generator: torch.Generator, num_envs: int
              ) -> Tuple[Game2048State, TimeStep]:
        return self.reset_from_draws(self._draws(generator, (num_envs, 2)), generator)

    def reset_from_draws(self, draws: Tuple[torch.Tensor, torch.Tensor],
                         generator: torch.Generator) -> Tuple[Game2048State, TimeStep]:
        """Two spawns on an empty board, from their Gumbel noise [E, 2, 16]
        and uniforms [E, 2]."""
        device = generator.device
        noise = draws[0].to(device=device, dtype=torch.float32)
        uniform = draws[1].to(device=device, dtype=torch.float32)
        n = noise.shape[0]
        board = torch.zeros((n, _SIZE, _SIZE), dtype=torch.int64, device=device)
        for i in range(2):
            board = spawn(board, noise[:, i], uniform[:, i])
        state = self._make_state(generator, board,
                                 torch.zeros((n,), dtype=torch.int32, device=device))
        ts = restart(self._observe(state), n, device)
        ts.extras["truncation"] = torch.zeros((n,), dtype=torch.bool, device=device)
        return state, ts

    def step(self, state: Game2048State, action: torch.Tensor
             ) -> Tuple[Game2048State, TimeStep]:
        return self.step_from_draws(
            state, action, self._draws(state.generator, (state.board.shape[0],)))

    def step_from_draws(self, state: Game2048State, action: torch.Tensor,
                        draws: Tuple[torch.Tensor, torch.Tensor]
                        ) -> Tuple[Game2048State, TimeStep]:
        """One move with the spawn's Gumbel noise [E, 16] and uniform [E] given."""
        device = state.board.device
        noise = draws[0].to(device=device, dtype=torch.float32)
        uniform = draws[1].to(device=device, dtype=torch.float32)
        action = action.reshape(-1).to(device=device, dtype=torch.int64)
        env = torch.arange(action.shape[0], device=device)
        valid = state.move_changed[env, action]
        moved = state.move_boards[env, action]
        board = torch.where(valid[:, None, None], spawn(moved, noise, uniform), state.board)
        reward = torch.where(valid, state.move_scores[env, action], 0.0)

        next_state = self._make_state(state.generator, board, state.step_count + 1)
        obs = self._observe(next_state)
        terminated = ~(obs.action_mask > 0).any(dim=-1)  # no move changes the board
        truncated = (next_state.step_count >= self._max_steps) & ~terminated
        ts = select_step(
            terminated,
            termination(reward, obs),
            select_step(truncated, truncation(reward, obs), transition(reward, obs)),
        )
        ts.extras["truncation"] = truncated
        return next_state, ts
