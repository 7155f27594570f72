"""DoorKey as a batched tensor env (counterpart of stoix_tpu/envs/doorkey.py).

A wall splits the room; the agent must pick up the key, open the door and
reach the goal. The observation is a 5x5 egocentric view (the agent at the
bottom centre, facing up) of the five channels (wall, closed door, open
door, key, goal) plus a has-key plane. Actions: 0 turn left, 1 turn right, 2
forward, 3 pickup, 4 toggle.

Every env has its own heading, so the view is one batched gather: for
heading k and view cell (a, b) the cell read is the agent's cell plus a fixed
offset (`_VIEW_OFFSETS`, the JAX package's rot90 then slice written as
offsets), and a cell off the grid reads zeros, as the JAX package's padding.

Reset draws seven values: the wall column, the door row, Gumbel noise over
the cells for the agent, the key and the goal, and the heading.
`reset_from_draws(draws, generator)` takes them given (see `DoorKeyDraws`),
so the tests can feed the JAX package's; `step` draws nothing.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
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

_VIEW = 5
_C = 5  # channels: 0 wall, 1 closed door, 2 open door, 3 key, 4 goal


@functools.lru_cache(maxsize=None)
def _view_offsets(device: torch.device) -> torch.Tensor:
    """[4, 5, 5, 2] (row, col) offsets from the agent of view cell (a, b)
    under heading k: the JAX package rotates the padded world by k quarter
    turns and slices rows r' - 4 .. r', cols c' - 2 .. c' + 2 around the
    agent's rotated cell (r', c')."""
    out = []
    for k in range(4):
        rows = []
        for a in range(_VIEW):
            rows.append([((a - 4, b - 2), (b - 2, 4 - a), (4 - a, 2 - b), (2 - b, a - 4))[k]
                         for b in range(_VIEW)])
        out.append(rows)
    return torch.tensor(out, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _headings(device: torch.device) -> torch.Tensor:
    """Row/col deltas for headings 0 up, 1 right, 2 down, 3 left."""
    return torch.tensor(((-1, 0), (0, 1), (1, 0), (0, -1)), dtype=torch.int64, device=device)


class DoorKeyDraws(NamedTuple):
    wall_col: torch.Tensor  # [E] integers in [2, size - 2)
    door_row: torch.Tensor  # [E] integers in [1, size - 1)
    agent: torch.Tensor  # [E, size * size] Gumbel noise
    key: torch.Tensor  # [E, size * size]
    goal: torch.Tensor  # [E, size * size]
    heading: torch.Tensor  # [E] integers in [0, 4)


class DoorKeyState(NamedTuple):
    generator: torch.Generator
    agent_rc: torch.Tensor  # [E, 2] int64
    agent_dir: torch.Tensor  # [E] int64
    has_key: torch.Tensor  # [E] bool
    door_open: torch.Tensor  # [E] bool
    key_rc: torch.Tensor  # [E, 2] ((-1, -1) once picked up)
    door_rc: torch.Tensor  # [E, 2]
    goal_rc: torch.Tensor  # [E, 2]
    wall_col: torch.Tensor  # [E]
    step_count: torch.Tensor  # [E] int32


class DoorKey(Environment):
    """Key -> door -> goal gridworld with a 5x5 egocentric view."""

    def __init__(self, size: int = 6, max_steps: int = 0):
        if int(size) < 5:
            raise ValueError(
                f"DoorKey needs size >= 5 (got {size}): the layout requires a "
                "border, an interior wall column, and a free column each side"
            )
        self._n = int(size)
        self._max_steps = int(max_steps) if max_steps else 4 * self._n * self._n
        self._inv_max_steps = float(np.float32(1.0) / np.float32(self._max_steps))

    def observation_space(self) -> Observation:
        return Observation(
            agent_view=spaces.Array((_VIEW, _VIEW, _C + 1), torch.float32),
            action_mask=spaces.Array((5,), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(5)

    # -- layout ----------------------------------------------------------

    def _coords(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.arange(self._n, device=device)[None, :, None],
                torch.arange(self._n, device=device)[None, None, :])

    def _grid(self, state: DoorKeyState) -> torch.Tensor:
        """Dense [E, N, N, C] channel grid of every env."""
        n = self._n
        rows, cols = self._coords(state.wall_col.device)

        def at(rc):
            return (rows == rc[:, 0, None, None]) & (cols == rc[:, 1, None, None])

        border = (rows == 0) | (rows == n - 1) | (cols == 0) | (cols == n - 1)
        door = at(state.door_rc)
        wall = (border | (cols == state.wall_col[:, None, None])) & ~door
        open_ = state.door_open[:, None, None]
        return torch.stack([wall, door & ~open_, door & open_, at(state.key_rc),
                            at(state.goal_rc)], dim=-1).to(torch.float32)

    def _observe(self, state: DoorKeyState) -> Observation:
        """The 5x5 egocentric view, one batched gather over the grid."""
        n, e = self._n, state.agent_dir.shape[0]
        device = state.agent_dir.device
        grid = self._grid(state).reshape(e, n * n, _C)
        cells = state.agent_rc[:, None, None] + _view_offsets(device)[state.agent_dir]
        inside = ((cells >= 0) & (cells < n)).all(dim=-1)  # [E, 5, 5]
        flat = torch.where(inside, cells[..., 0] * n + cells[..., 1], 0).reshape(e, -1)
        view = torch.gather(grid, 1, flat[..., None].expand(-1, -1, _C)).reshape(
            e, _VIEW, _VIEW, _C)
        view = view * inside[..., None].to(torch.float32)
        carried = state.has_key.to(torch.float32)[:, None, None, None].expand(
            -1, _VIEW, _VIEW, 1)
        return Observation(
            agent_view=torch.cat([view, carried], dim=-1),
            action_mask=torch.ones((e, 5), dtype=torch.float32, device=device),
            step_count=state.step_count,
        )

    # -- episode ---------------------------------------------------------

    def reset(self, generator: torch.Generator, num_envs: int
              ) -> Tuple[DoorKeyState, TimeStep]:
        n, device = self._n, generator.device

        def randint(low, high):
            return torch.randint(low, high, (num_envs,), generator=generator, device=device)

        draws = DoorKeyDraws(randint(2, n - 2), randint(1, n - 1),
                             *(gumbel(generator, (num_envs, n * n)) for _ in range(3)),
                             randint(0, 4))
        return self.reset_from_draws(draws, generator)

    def reset_from_draws(self, draws: DoorKeyDraws, generator: torch.Generator
                         ) -> Tuple[DoorKeyState, TimeStep]:
        """Lay out every env from its seven draws: the agent and the key left
        of the wall (the key off the agent's cell), the goal right of it."""
        n, device = self._n, generator.device
        draws = DoorKeyDraws(*(d.to(device) for d in draws))
        wall_col = draws.wall_col.to(torch.int64)
        e = wall_col.shape[0]
        door_rc = torch.stack([draws.door_row.to(torch.int64), wall_col], dim=-1)
        rows, cols = self._coords(device)
        interior = (rows > 0) & (rows < n - 1) & (cols > 0) & (cols < n - 1)
        left = interior & (cols < wall_col[:, None, None])
        right = interior & (cols > wall_col[:, None, None])

        def choice(noise, mask):
            idx = masked_argmax(noise.to(torch.float32), mask.reshape(e, -1))
            return torch.stack([idx // n, idx % n], dim=-1)

        agent_rc = choice(draws.agent, left)
        on_agent = (rows == agent_rc[:, 0, None, None]) & (cols == agent_rc[:, 1, None, None])
        key_rc = choice(draws.key, left & ~on_agent)
        goal_rc = choice(draws.goal, right)
        false = torch.zeros((e,), dtype=torch.bool, device=device)
        state = DoorKeyState(generator, agent_rc, draws.heading.to(torch.int64), false, false,
                             key_rc, door_rc, goal_rc, wall_col,
                             torch.zeros((e,), dtype=torch.int32, device=device))
        ts = restart(self._observe(state), e, device)
        ts.extras["truncation"] = torch.zeros((e,), dtype=torch.bool, device=device)
        return state, ts

    def step(self, state: DoorKeyState, action: torch.Tensor) -> Tuple[DoorKeyState, TimeStep]:
        n, device = self._n, state.agent_dir.device
        action = action.reshape(-1).to(device=device, dtype=torch.int64)
        d = state.agent_dir
        ahead = state.agent_rc + _headings(device)[d]

        new_dir = torch.where(action == 0, (d - 1) % 4, torch.where(action == 1, (d + 1) % 4, d))

        # Forward: blocked by walls, the closed door and the unpicked key.
        grid = self._grid(state)
        e = torch.arange(d.shape[0], device=device)
        cell = grid[e, torch.clamp(ahead[:, 0], 0, n - 1), torch.clamp(ahead[:, 1], 0, n - 1)]
        blocked = (cell[:, 0] > 0) | (cell[:, 1] > 0) | (cell[:, 3] > 0)
        new_rc = torch.where(((action == 2) & ~blocked)[:, None], ahead, state.agent_rc)

        facing_key = (ahead == state.key_rc).all(dim=-1)
        picked = (action == 3) & facing_key & ~state.has_key
        has_key = state.has_key | picked
        key_rc = torch.where(picked[:, None], torch.full_like(state.key_rc, -1), state.key_rc)

        facing_door = (ahead == state.door_rc).all(dim=-1)
        door_open = state.door_open | ((action == 4) & facing_door & has_key)

        next_state = DoorKeyState(state.generator, new_rc, new_dir, has_key, door_open, key_rc,
                                  state.door_rc, state.goal_rc, state.wall_col,
                                  state.step_count + 1)
        at_goal = (new_rc == state.goal_rc).all(dim=-1)
        # 1 - 0.9 t / max_steps, the division by the constant a multiply by
        # its float32 reciprocal, as XLA compiles it.
        shaped = 1.0 - 0.9 * next_state.step_count.to(torch.float32) * self._inv_max_steps
        reward = torch.where(at_goal, shaped, 0.0)
        terminated = at_goal
        truncated = (next_state.step_count >= self._max_steps) & ~terminated
        obs = self._observe(next_state)
        ts = select_step(
            terminated,
            termination(reward, obs),
            select_step(truncated, truncation(reward, obs), transition(reward, obs)),
        )
        ts.extras["truncation"] = truncated
        return next_state, ts
