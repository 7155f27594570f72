"""Snake as a batched tensor env (counterpart of stoix_tpu/envs/snake.py).

The JAX package's rules, on a leading env axis: the body is a fixed
[E, max_len, 2] position buffer, head first, with a length counter; eating
fruit grows the snake and scores +1; leaving the board or hitting the body
ends the episode. The observation is the [rows, cols, 5] grid (body without
head, head, tail, fruit, body order) and the mask excludes the reverse of the
heading once the snake is longer than one.

Fruit spawns as `jax.random.categorical` draws it: the argmax of Gumbel noise
over the cells, occupied cells at -inf. `reset_from_draws((head_cell,
gumbel), generator)` resets from given draws and `step_from_draws(state,
action, gumbel)` steps with given [E, cells] Gumbel noise, so the tests can
feed the JAX package's; `step` draws the noise from the env's generator.
"""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=None)
def _deltas(device: torch.device) -> torch.Tensor:
    """Row/col deltas for up, right, down, left, on `device` once."""
    return torch.tensor(((-1, 0), (0, 1), (1, 0), (0, -1)), device=device)


class SnakeState(NamedTuple):
    generator: torch.Generator
    body: torch.Tensor  # [E, max_len, 2] int64, head first; rows past length unused
    length: torch.Tensor  # [E] int64
    heading: torch.Tensor  # [E] int64, the last action
    fruit: torch.Tensor  # [E, 2] int64
    step_count: torch.Tensor  # [E] int32


def gumbel(generator: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform on [0, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u))


def masked_argmax(noise: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis of the noise where allowed, -inf elsewhere
    (the first index when none is allowed, as `jnp.argmax`)."""
    return torch.argmax(torch.where(allowed, noise, torch.full_like(noise, -torch.inf)), dim=-1)


class Snake(Environment):
    def __init__(self, num_rows: int = 12, num_cols: int = 12, max_steps: int = 500):
        self._rows = int(num_rows)
        self._cols = int(num_cols)
        self._cells = self._rows * self._cols
        self._max_len = self._cells
        self._max_steps = int(max_steps)

    def observation_space(self) -> Observation:
        return Observation(
            agent_view=spaces.Array((self._rows, self._cols, 5), torch.float32),
            action_mask=spaces.Array((4,), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(4)

    # ------------------------------------------------------------------ helpers
    def _cell_index(self, body: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat cell index of every body row and whether the JAX package's
        `.at[flat]` writes it: a negative index counts from the end, as in
        Python (a head off the top edge lands in the last row), and an index
        still out of range is dropped. A row past the last column lands on
        the next row's first cell."""
        flat = body[..., 0] * self._cols + body[..., 1]
        flat = torch.where(flat < 0, flat + self._cells, flat)
        inside = (flat >= 0) & (flat < self._cells)
        return torch.clamp(flat, 0, self._cells - 1), inside

    def _paint(self, flat: torch.Tensor, inside: torch.Tensor, values: torch.Tensor
               ) -> torch.Tensor:
        """zeros[cells].at[flat].max(values) for every env (values >= 0)."""
        cells = torch.zeros((flat.shape[0], self._cells), dtype=torch.float32, device=flat.device)
        values = torch.where(inside, values, torch.zeros_like(values))
        return cells.scatter_reduce(1, flat, values, reduce="amax")

    def _grid_obs(self, state: SnakeState) -> Observation:
        n, device = state.length.shape[0], state.length.device
        rows = torch.arange(self._max_len, device=device)
        live = rows[None] < state.length[:, None]
        flat, inside = self._cell_index(state.body)
        live_f = live.to(torch.float32)
        head_onehot = (rows == 0).to(torch.float32).expand(n, -1)
        tail_idx = torch.clamp(state.length - 1, min=0)
        tail_onehot = (rows[None] == tail_idx[:, None]).to(torch.float32) * live_f
        # Body order: head 1.0 decaying linearly along the current body.
        length_f = torch.clamp(state.length, min=1).to(torch.float32)
        order = (1.0 - rows.to(torch.float32)[None] / length_f[:, None]) * live_f

        planes = [self._paint(flat, inside, v) for v in
                  (live_f * (1.0 - head_onehot), head_onehot, tail_onehot)]
        fruit = torch.zeros((n, self._cells), dtype=torch.float32, device=device)
        fruit.scatter_(1, (state.fruit[:, 0] * self._cols + state.fruit[:, 1])[:, None], 1.0)
        planes += [fruit, self._paint(flat, inside, order)]
        view = torch.stack(planes, dim=-1).reshape(n, self._rows, self._cols, 5)
        # Mask out the reverse of the current heading (stepping into the neck).
        reverse = (state.heading + 2) % 4
        blocked = (torch.arange(4, device=device)[None] == reverse[:, None]) & (
            state.length[:, None] > 1)
        mask = torch.where(blocked, 0.0, 1.0)
        return Observation(agent_view=view, action_mask=mask, step_count=state.step_count)

    def _spawn_fruit(self, noise: torch.Tensor, body: torch.Tensor, length: torch.Tensor
                     ) -> torch.Tensor:
        n, device = length.shape[0], length.device
        flat, inside = self._cell_index(body)
        live = torch.arange(self._max_len, device=device)[None] < length[:, None]
        occupied = self._paint(flat, inside, live.to(torch.float32)) > 0
        cell = masked_argmax(noise, ~occupied)
        return torch.stack([cell // self._cols, cell % self._cols], dim=-1)

    # ------------------------------------------------------------------ api
    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[SnakeState, TimeStep]:
        head_cell = torch.randint(0, self._cells, (num_envs,), generator=generator,
                                  device=generator.device)
        return self.reset_from_draws((head_cell, gumbel(generator, (num_envs, self._cells))),
                                     generator)

    def reset_from_draws(self, draws: Tuple[torch.Tensor, torch.Tensor],
                         generator: torch.Generator) -> Tuple[SnakeState, TimeStep]:
        """Reset every env from its head cell [E] and the fruit's Gumbel
        noise [E, cells]: length 1, heading right."""
        device = generator.device
        head_cell = draws[0].to(device=device, dtype=torch.int64)
        noise = draws[1].to(device=device, dtype=torch.float32)
        n = head_cell.shape[0]
        body = torch.zeros((n, self._max_len, 2), dtype=torch.int64, device=device)
        body[:, 0, 0] = head_cell // self._cols
        body[:, 0, 1] = head_cell % self._cols
        length = torch.ones((n,), dtype=torch.int64, device=device)
        state = SnakeState(generator, body, length, torch.ones_like(length),
                           self._spawn_fruit(noise, body, length),
                           torch.zeros((n,), dtype=torch.int32, device=device))
        ts = restart(self._grid_obs(state), n, device)
        ts.extras["truncation"] = torch.zeros((n,), dtype=torch.bool, device=device)
        return state, ts

    def step(self, state: SnakeState, action: torch.Tensor) -> Tuple[SnakeState, TimeStep]:
        noise = gumbel(state.generator, (state.length.shape[0], self._cells))
        return self.step_from_draws(state, action, noise)

    def step_from_draws(self, state: SnakeState, action: torch.Tensor, noise: torch.Tensor
                        ) -> Tuple[SnakeState, TimeStep]:
        """One step with the fruit's Gumbel noise [E, cells] given."""
        device = state.length.device
        action = action.reshape(-1).to(device=device, dtype=torch.int64)
        noise = noise.to(device=device, dtype=torch.float32)
        # At length >= 3 a reversal hits the neck and dies; at length 2 it is
        # a legal head/tail swap (the mask discourages it).
        new_head = state.body[:, 0] + _deltas(device)[action]
        out_of_bounds = ((new_head[:, 0] < 0) | (new_head[:, 0] >= self._rows)
                         | (new_head[:, 1] < 0) | (new_head[:, 1] >= self._cols))
        ate = (new_head == state.fruit).all(dim=-1)
        new_length = state.length + ate.to(torch.int64)

        # The tail vacates unless the snake grew, so moving onto it is legal.
        rows = torch.arange(self._max_len, device=device)[None]
        live = rows < state.length[:, None]
        is_tail = rows == (state.length - 1)[:, None]
        blocking = live & (~is_tail | ate[:, None])
        hits_body = (blocking & (state.body == new_head[:, None]).all(dim=-1)).any(dim=-1)
        died = out_of_bounds | hits_body

        # Shift the body: new head at row 0, previous segments slide down.
        shifted = torch.roll(state.body, 1, dims=1)
        shifted[:, 0] = new_head
        new_fruit = torch.where(ate[:, None], self._spawn_fruit(noise, shifted, new_length),
                                state.fruit)
        next_state = SnakeState(state.generator, shifted, new_length, action, new_fruit,
                                state.step_count + 1)
        reward = ate.to(torch.float32)
        obs = self._grid_obs(next_state)
        terminated = died | (new_length >= self._max_len)
        truncated = (next_state.step_count >= self._max_steps) & ~terminated
        ts = select_step(
            terminated,
            termination(reward, obs),
            select_step(truncated, truncation(reward, obs), transition(reward, obs)),
        )
        ts.extras["truncation"] = truncated
        return next_state, ts
