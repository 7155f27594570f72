"""MinAtar-class grid games as batched tensor envs (counterpart of
stoix_tpu/envs/minatar.py: Breakout, Asterix, Freeway and SpaceInvaders).

Each game follows the JAX package's rules step for step, on a leading env
axis: a 10x10 board of 4 binary channels, integer state, every rule a
`torch.where` over all envs and every board write a batched index write, so
one step of every env is a fixed set of tensor ops with no host branching.

Only Breakout draws at reset (the serve's direction, a fair coin). Its
`reset_from_draws(inward, generator)` resets from given coins, so the tests
can feed the JAX package's draws; the port's generator stream differs from
JAX's keys. Asterix, Freeway and SpaceInvaders draw nothing.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from stoix_tpu_torch.envs import spaces
from stoix_tpu_torch.envs.core import Environment
from stoix_tpu_torch.envs.types import (
    Observation,
    TimeStep,
    put_inside,
    restart,
    select_step,
    termination,
    transition,
    truncation,
)

_GRID = 10
_BRICK_ROWS = 3
_PADDLE_ROW = _GRID - 1
_ASTERIX_SLOTS = 8
_SPAWN_PERIOD = 5
_MOVE_PERIOD = 2
_FREEWAY_START_R = _GRID - 1
_FREEWAY_START_C = _GRID // 2
_SI_ROWS = 4
_SI_COLS = 6
_SI_ALIEN_PERIOD = 4
_SI_SHOOT_PERIOD = 6


def _full(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full(like.shape, value, dtype=torch.int64, device=like.device)


class _GridGame(Environment):
    """Shared plumbing: the 10x10x4 observation, the all-ones action mask
    and the termination/truncation timestep."""

    _num_actions: int

    def __init__(self, max_steps: int = 500):
        self._max_steps = int(max_steps)

    def observation_space(self) -> Observation:
        return Observation(
            agent_view=spaces.Array((_GRID, _GRID, 4), torch.float32),
            action_mask=spaces.Array((self._num_actions,), torch.float32),
            step_count=spaces.Array((), torch.int32),
        )

    def action_space(self) -> spaces.Discrete:
        return spaces.Discrete(self._num_actions)

    def _board(self, step_count: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A zero board for every env and the env index."""
        n, device = step_count.shape[0], step_count.device
        return (torch.zeros((n, _GRID, _GRID, 4), dtype=torch.float32, device=device),
                torch.arange(n, device=device))

    def _observation(self, board: torch.Tensor, step_count: torch.Tensor) -> Observation:
        return Observation(
            agent_view=board,
            action_mask=torch.ones((board.shape[0], self._num_actions), dtype=torch.float32,
                                   device=board.device),
            step_count=step_count,
        )

    def _restart(self, state: Any) -> Tuple[Any, TimeStep]:
        n, device = state.step_count.shape[0], state.step_count.device
        ts = restart(self._observe(state), n, device)
        ts.extras["truncation"] = torch.zeros((n,), dtype=torch.bool, device=device)
        return state, ts

    def _timestep(self, state: Any, reward: torch.Tensor, terminated: torch.Tensor
                  ) -> Tuple[Any, TimeStep]:
        obs = self._observe(state)
        truncated = (state.step_count >= self._max_steps) & ~terminated
        ts = select_step(
            terminated,
            termination(reward, obs),
            select_step(truncated, truncation(reward, obs), transition(reward, obs)),
        )
        ts.extras["truncation"] = truncated
        return state, ts

    def _observe(self, state: Any) -> Observation:
        raise NotImplementedError


class BreakoutState(NamedTuple):
    generator: torch.Generator
    ball_r: torch.Tensor  # [N] int64
    ball_c: torch.Tensor
    dr: torch.Tensor  # {-1, +1}
    dc: torch.Tensor
    last_r: torch.Tensor
    last_c: torch.Tensor
    paddle: torch.Tensor
    bricks: torch.Tensor  # [N, 3, 10] int64 in {0, 1}
    step_count: torch.Tensor  # [N] int32


class Breakout(_GridGame):
    """Breakout: 3 actions (left/stay/right); the serve starts from a top
    corner below the 3-row brick band, moving down and inward; a brick
    reflects the ball and scores +1; losing the ball past the paddle
    terminates. Channels: paddle, ball, trail, brick."""

    _num_actions = 3

    def _observe(self, state: BreakoutState) -> Observation:
        board, env = self._board(state.step_count)
        board[env, _PADDLE_ROW, state.paddle, 0] = 1.0
        # The ball leaves the board past the paddle row once an episode ends.
        put_inside(board, (env, state.ball_r, state.ball_c, 1), 1.0)
        put_inside(board, (env, state.last_r, state.last_c, 2), 1.0)
        board[:, 1:_BRICK_ROWS + 1, :, 3] = state.bricks.to(torch.float32)
        return self._observation(board, state.step_count)

    def reset(self, generator: torch.Generator, num_envs: int
              ) -> Tuple[BreakoutState, TimeStep]:
        inward = torch.rand((num_envs,), generator=generator, device=generator.device) < 0.5
        return self.reset_from_draws(inward, generator)

    def reset_from_draws(self, inward: torch.Tensor, generator: torch.Generator
                         ) -> Tuple[BreakoutState, TimeStep]:
        """Serve every env from its coin ([N] bools): inward from the left
        corner, else from the right."""
        inward = inward.to(device=generator.device, dtype=torch.bool)
        dc = torch.where(inward, 1, -1).to(torch.int64)
        ball_c = torch.where(inward, 0, _GRID - 1).to(torch.int64)
        ball_r = _full(_BRICK_ROWS + 1, dc)
        state = BreakoutState(
            generator, ball_r, ball_c, _full(1, dc), dc, ball_r, ball_c,
            _full(_GRID // 2, dc),
            torch.ones((dc.shape[0], _BRICK_ROWS, _GRID), dtype=torch.int64, device=dc.device),
            torch.zeros(dc.shape, dtype=torch.int32, device=dc.device),
        )
        return self._restart(state)

    def step(self, state: BreakoutState, action: torch.Tensor
             ) -> Tuple[BreakoutState, TimeStep]:
        env = torch.arange(state.paddle.shape[0], device=state.paddle.device)
        paddle = torch.clamp(state.paddle + (action.to(torch.int64) - 1), 0, _GRID - 1)
        # Side-wall bounce.
        nc0 = state.ball_c + state.dc
        dc = torch.where((nc0 < 0) | (nc0 >= _GRID), -state.dc, state.dc)
        nc = state.ball_c + dc
        # Ceiling bounce.
        dr = torch.where(state.ball_r + state.dr < 0, 1, state.dr)
        nr = state.ball_r + dr
        # Brick hit: break it, reflect vertically, score.
        in_band = (nr >= 1) & (nr <= _BRICK_ROWS)
        brick_row = torch.clamp(nr - 1, 0, _BRICK_ROWS - 1)
        hit = in_band & (state.bricks[env, brick_row, nc] == 1)
        bricks = state.bricks.clone()
        bricks[env, brick_row, nc] = torch.where(hit, 0, state.bricks[env, brick_row, nc])
        reward = hit.to(torch.float32)
        dr = torch.where(hit, -dr, dr)
        nr_after_hit = torch.where(hit, state.ball_r, nr)
        # All bricks cleared -> a fresh wall (play continues).
        bricks = torch.where((bricks == 1).any(2).any(1)[:, None, None], bricks, 1)
        # Paddle row: bounce if caught, terminate if lost.
        at_paddle = ~hit & (nr == _PADDLE_ROW)
        caught = at_paddle & (nc == paddle)
        terminated = at_paddle & (nc != paddle)
        dr = torch.where(caught, -1, dr)
        nr_final = torch.where(caught, state.ball_r, nr_after_hit)
        next_state = BreakoutState(state.generator, nr_final, nc, dr, dc, state.ball_r,
                                   state.ball_c, paddle, bricks, state.step_count + 1)
        return self._timestep(next_state, reward, terminated)


class AsterixState(NamedTuple):
    generator: torch.Generator
    player_r: torch.Tensor  # [N] int64
    player_c: torch.Tensor
    active: torch.Tensor  # [N, 8] int64 in {0, 1}
    col: torch.Tensor  # [N, 8]
    dirn: torch.Tensor  # [N, 8] in {-1, +1}
    gold: torch.Tensor  # [N, 8] in {0, 1}
    spawn_count: torch.Tensor  # [N]
    t: torch.Tensor  # [N] in-episode step index, drives the schedules
    step_count: torch.Tensor  # [N] int32


class Asterix(_GridGame):
    """Asterix: 5 actions (stay/left/up/right/down); entities stream across
    rows 1..8 on a deterministic spawn schedule; touching gold scores +1,
    touching an enemy terminates. Channels: player, enemy, gold,
    moving-right."""

    _num_actions = 5

    def _observe(self, state: AsterixState) -> Observation:
        board, env = self._board(state.step_count)
        board[env, state.player_r, state.player_c, 0] = 1.0
        # Slot i lives on row i + 1, so no two slots of an env share a cell
        # and flax's `.max` into a zero channel is a write.
        n = env.shape[0]
        envs = env[:, None].expand(n, _ASTERIX_SLOTS)
        rows = (torch.arange(_ASTERIX_SLOTS, device=env.device) + 1).expand(n, _ASTERIX_SLOTS)
        live = state.active.to(torch.float32)
        is_gold = state.gold.to(torch.float32)
        board[envs, rows, state.col, 1] = live * (1.0 - is_gold)
        board[envs, rows, state.col, 2] = live * is_gold
        board[envs, rows, state.col, 3] = live * (state.dirn > 0).to(torch.float32)
        return self._observation(board, state.step_count)

    def reset(self, generator: torch.Generator, num_envs: int
              ) -> Tuple[AsterixState, TimeStep]:
        device = generator.device

        def slots(value: int) -> torch.Tensor:
            return torch.full((num_envs, _ASTERIX_SLOTS), value, dtype=torch.int64,
                              device=device)

        zero = torch.zeros((num_envs,), dtype=torch.int64, device=device)
        state = AsterixState(
            generator, zero + _GRID // 2, zero + _GRID // 2, slots(0), slots(0), slots(1),
            slots(0), zero, zero, torch.zeros((num_envs,), dtype=torch.int32, device=device),
        )
        return self._restart(state)

    def step(self, state: AsterixState, action: torch.Tensor
             ) -> Tuple[AsterixState, TimeStep]:
        device = state.player_r.device
        action = action.to(torch.int64)
        drs = torch.tensor([0, 0, -1, 0, 1], dtype=torch.int64, device=device)
        dcs = torch.tensor([0, -1, 0, 1, 0], dtype=torch.int64, device=device)
        player_r = torch.clamp(state.player_r + drs[action], 0, _GRID - 1)
        player_c = torch.clamp(state.player_c + dcs[action], 0, _GRID - 1)
        slot_ids = torch.arange(_ASTERIX_SLOTS, device=device)
        rows = slot_ids + 1

        def collide(active, gold, col, reward, terminated):
            on_player = ((active == 1) & (player_r[:, None] == rows)
                         & (player_c[:, None] == col))
            got_gold = on_player & (gold == 1)
            hit_enemy = (on_player & (gold == 0)).any(1)
            reward = reward + got_gold.to(torch.float32).sum(1)
            return torch.where(got_gold, 0, active), reward, terminated | hit_enemy

        active, gold, dirn, col = state.active, state.gold, state.dirn, state.col
        reward = torch.zeros(player_r.shape, dtype=torch.float32, device=device)
        terminated = torch.zeros(player_r.shape, dtype=torch.bool, device=device)
        active, reward, terminated = collide(active, gold, col, reward, terminated)

        # Entity movement every _MOVE_PERIOD steps.
        move_now = state.t % _MOVE_PERIOD == 0
        new_col = col + dirn
        off = (new_col < 0) | (new_col >= _GRID)
        moved_col = torch.where(move_now[:, None], new_col, col)
        active = torch.where(move_now[:, None] & off, 0, active)
        col = torch.clamp(moved_col, 0, _GRID - 1)
        a2, r2, t2 = collide(active, gold, col, reward, terminated)
        active = torch.where(move_now[:, None], a2, active)
        reward = torch.where(move_now, r2, reward)
        terminated = torch.where(move_now, t2, terminated)

        # Deterministic spawn schedule every _SPAWN_PERIOD steps.
        spawn_now = state.t % _SPAWN_PERIOD == 0
        slot = state.spawn_count % _ASTERIX_SLOTS
        slot_free = active.gather(1, slot[:, None])[:, 0] == 0
        do_spawn = spawn_now & slot_free
        new_dir = torch.where((state.spawn_count // _ASTERIX_SLOTS + slot) % 2 == 0, 1, -1)
        spawn_col = torch.where(new_dir > 0, 0, _GRID - 1)
        new_gold = torch.where(state.spawn_count % 3 == 0, 1, 0)
        spawned = (slot_ids == slot[:, None]) & do_spawn[:, None]
        active = torch.where(spawned, 1, active)
        dirn = torch.where(spawned, new_dir[:, None], dirn)
        col = torch.where(spawned, spawn_col[:, None], col)
        gold = torch.where(spawned, new_gold[:, None], gold)
        a3, r3, t3 = collide(active, gold, col, reward, terminated)
        active = torch.where(do_spawn[:, None], a3, active)
        reward = torch.where(do_spawn, r3, reward)
        terminated = torch.where(do_spawn, t3, terminated)

        next_state = AsterixState(
            state.generator, player_r, player_c, active, col, dirn, gold,
            state.spawn_count + spawn_now.to(torch.int64), state.t + 1, state.step_count + 1,
        )
        return self._timestep(next_state, reward, terminated)


class FreewayState(NamedTuple):
    generator: torch.Generator
    player_r: torch.Tensor  # [N] int64
    player_c: torch.Tensor
    car_col: torch.Tensor  # [N, 8]
    t: torch.Tensor  # [N] drives the lanes' movement periods
    step_count: torch.Tensor  # [N] int32


class Freeway(_GridGame):
    """Freeway: cross 8 lanes of traffic, +1 a crossing. Lane s moves every
    1 + s % 3 steps, to the right when s is even; a collision sends the
    chicken back to the start. No termination: the episode only truncates.
    Channels: player, car, car moving right, fast car. Actions: stay, up,
    down."""

    _num_actions = 3

    @staticmethod
    def _lanes(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(directions, periods) of the 8 lanes."""
        lane = torch.arange(8, device=device)
        return torch.where(lane % 2 == 0, 1, -1), 1 + lane % 3

    def _observe(self, state: FreewayState) -> Observation:
        board, env = self._board(state.step_count)
        board[env, state.player_r, state.player_c, 0] = 1.0
        n = env.shape[0]
        envs = env[:, None].expand(n, 8)
        rows = (torch.arange(8, device=env.device) + 1).expand(n, 8)
        dirs, periods = self._lanes(env.device)
        board[envs, rows, state.car_col, 1] = 1.0
        board[envs, rows, state.car_col, 2] = (dirs > 0).to(torch.float32).expand(n, 8)
        board[envs, rows, state.car_col, 3] = (periods == 1).to(torch.float32).expand(n, 8)
        return self._observation(board, state.step_count)

    def reset(self, generator: torch.Generator, num_envs: int
              ) -> Tuple[FreewayState, TimeStep]:
        device = generator.device
        zero = torch.zeros((num_envs,), dtype=torch.int64, device=device)
        car_col = ((3 * torch.arange(8, device=device) + 1) % _GRID).expand(num_envs, 8)
        state = FreewayState(generator, zero + _FREEWAY_START_R, zero + _FREEWAY_START_C,
                             car_col.contiguous(), zero,
                             torch.zeros((num_envs,), dtype=torch.int32, device=device))
        return self._restart(state)

    def step(self, state: FreewayState, action: torch.Tensor
             ) -> Tuple[FreewayState, TimeStep]:
        action = action.to(torch.int64)
        dirs, periods = self._lanes(state.player_r.device)
        dr = torch.where(action == 1, -1, torch.where(action == 2, 1, 0))
        player_r = torch.clamp(state.player_r + dr, 0, _GRID - 1)
        player_c = state.player_c
        move_now = state.t[:, None] % periods == 0
        car_col = torch.where(move_now, (state.car_col + dirs) % _GRID, state.car_col)
        rows = torch.arange(8, device=player_r.device) + 1
        hit = ((player_r[:, None] == rows) & (player_c[:, None] == car_col)).any(1)
        player_r = torch.where(hit, _FREEWAY_START_R, player_r)
        player_c = torch.where(hit, _FREEWAY_START_C, player_c)
        crossed = player_r == 0
        reward = crossed.to(torch.float32)
        player_r = torch.where(crossed, _FREEWAY_START_R, player_r)
        player_c = torch.where(crossed, _FREEWAY_START_C, player_c)
        next_state = FreewayState(state.generator, player_r, player_c, car_col, state.t + 1,
                                  state.step_count + 1)
        obs = self._observe(next_state)
        truncated = next_state.step_count >= self._max_steps
        ts = select_step(truncated, truncation(reward, obs), transition(reward, obs))
        ts.extras["truncation"] = truncated
        return next_state, ts


class SpaceInvadersState(NamedTuple):
    generator: torch.Generator
    player_c: torch.Tensor  # [N] int64 (row fixed at the bottom)
    alive: torch.Tensor  # [N, 4, 6]
    alien_r0: torch.Tensor  # [N] the block's top-left
    alien_c0: torch.Tensor
    adir: torch.Tensor  # {-1, +1}
    fb_r: torch.Tensor  # friendly bullet
    fb_c: torch.Tensor
    fb_live: torch.Tensor
    eb_r: torch.Tensor  # enemy bullet
    eb_c: torch.Tensor
    eb_live: torch.Tensor
    shot_count: torch.Tensor
    t: torch.Tensor
    step_count: torch.Tensor  # [N] int32


class SpaceInvaders(_GridGame):
    """Space Invaders: the 4x6 alien block marches every 4 steps (drop and
    reverse at the walls); every 6 steps the lowest alien of a cycling column
    fires; one friendly and one enemy bullet may fly. +1 an alien; being
    shot or invaded terminates. Channels: player, alien, friendly bullet,
    enemy bullet. Actions: stay, left, right, fire."""

    _num_actions = 4

    def _observe(self, state: SpaceInvadersState) -> Observation:
        board, env = self._board(state.step_count)
        device, n = env.device, env.shape[0]
        board[env, _GRID - 1, state.player_c, 0] = 1.0
        # Rows past the bottom clip onto row 9, so several aliens can share a
        # cell: flax's `.max` there is a scatter-max.
        rr = torch.clamp(state.alien_r0[:, None] + torch.arange(_SI_ROWS, device=device), 0,
                         _GRID - 1)
        cc = torch.clamp(state.alien_c0[:, None] + torch.arange(_SI_COLS, device=device), 0,
                         _GRID - 1)
        cells = (rr[:, :, None] * _GRID + cc[:, None, :]).reshape(n, -1)
        aliens = torch.zeros((n, _GRID * _GRID), dtype=torch.float32, device=device)
        aliens = aliens.scatter_reduce(1, cells, state.alive.to(torch.float32).reshape(n, -1),
                                       reduce="amax")
        board[..., 1] = aliens.reshape(n, _GRID, _GRID)
        board[env, torch.clamp(state.fb_r, 0, _GRID - 1), torch.clamp(state.fb_c, 0, _GRID - 1),
              2] = state.fb_live.to(torch.float32)
        board[env, torch.clamp(state.eb_r, 0, _GRID - 1), torch.clamp(state.eb_c, 0, _GRID - 1),
              3] = state.eb_live.to(torch.float32)
        return self._observation(board, state.step_count)

    def reset(self, generator: torch.Generator, num_envs: int
              ) -> Tuple[SpaceInvadersState, TimeStep]:
        device = generator.device
        zero = torch.zeros((num_envs,), dtype=torch.int64, device=device)
        alive = torch.ones((num_envs, _SI_ROWS, _SI_COLS), dtype=torch.int64, device=device)
        state = SpaceInvadersState(
            generator, zero + _GRID // 2, alive, zero + 1, zero + 2, zero + 1,
            zero, zero, zero, zero, zero, zero, zero, zero,
            torch.zeros((num_envs,), dtype=torch.int32, device=device),
        )
        return self._restart(state)

    def step(self, state: SpaceInvadersState, action: torch.Tensor
             ) -> Tuple[SpaceInvadersState, TimeStep]:
        # Phase order: player/fire -> friendly bullet -> enemy bullet ->
        # march -> shoot -> wave refresh.
        device = state.player_c.device
        action = action.to(torch.int64)
        player_c = torch.clamp(
            state.player_c + torch.where(action == 1, -1, torch.where(action == 2, 1, 0)),
            0, _GRID - 1)
        fire = (action == 3) & (state.fb_live == 0)
        fb_live = torch.where(fire, 1, state.fb_live)
        fb_r = torch.where(fire, _GRID - 2, state.fb_r)
        fb_c = torch.where(fire, player_c, state.fb_c)

        # Friendly bullet: up one, dies off the top, then the alien hit check.
        fb_r = torch.where(fb_live == 1, fb_r - 1, fb_r)
        fb_live = torch.where(fb_r < 0, 0, fb_live)
        rel_r = fb_r - state.alien_r0
        rel_c = fb_c - state.alien_c0
        in_block = (rel_r >= 0) & (rel_r < _SI_ROWS) & (rel_c >= 0) & (rel_c < _SI_COLS)
        rel_r_c = torch.clamp(rel_r, 0, _SI_ROWS - 1)
        rel_c_c = torch.clamp(rel_c, 0, _SI_COLS - 1)
        target = ((torch.arange(_SI_ROWS, device=device)[:, None] == rel_r_c[:, None, None])
                  & (torch.arange(_SI_COLS, device=device) == rel_c_c[:, None, None]))
        target_alive = (state.alive * target).sum((1, 2))
        hit = (fb_live == 1) & in_block & (target_alive == 1)
        alive = torch.where(target & hit[:, None, None], 0, state.alive)
        reward = hit.to(torch.float32)
        fb_live = torch.where(hit, 0, fb_live)

        # Enemy bullet: down one, dies off the bottom; hitting the player
        # terminates.
        eb_r = torch.where(state.eb_live == 1, state.eb_r + 1, state.eb_r)
        eb_live = torch.where(eb_r >= _GRID, 0, state.eb_live)
        shot_down = (eb_live == 1) & (eb_r == _GRID - 1) & (state.eb_c == player_c)

        # The march every _SI_ALIEN_PERIOD steps: sideways, or drop and reverse.
        march_now = state.t % _SI_ALIEN_PERIOD == 0
        nc0 = state.alien_c0 + state.adir
        blocked = (nc0 < 0) | (nc0 + _SI_COLS > _GRID)
        alien_c0 = torch.where(march_now & ~blocked, nc0, state.alien_c0)
        alien_r0 = torch.where(march_now & blocked, state.alien_r0 + 1, state.alien_r0)
        adir = torch.where(march_now & blocked, -state.adir, state.adir)
        # Invasion: the lowest LIVING alien row reaching the player's row.
        row_ids = torch.arange(_SI_ROWS, device=device)
        lowest = torch.where((alive == 1).any(2), row_ids, -1).amax(1)
        invaded = (lowest >= 0) & (alien_r0 + lowest >= _GRID - 1)

        # An enemy shot every _SI_SHOOT_PERIOD steps from the lowest living
        # alien of a cycling column.
        shoot_period = state.t % _SI_SHOOT_PERIOD == 0
        shoot_now = shoot_period & (eb_live == 0)
        sc = state.shot_count % _SI_COLS
        col_alive = alive.gather(2, sc[:, None, None].expand(-1, _SI_ROWS, 1))[:, :, 0] == 1
        low_in_col = torch.where(col_alive, row_ids, -1).amax(1)
        can_shoot = shoot_now & (low_in_col >= 0)
        eb_live = torch.where(can_shoot, 1, eb_live)
        eb_r = torch.where(can_shoot, alien_r0 + low_in_col + 1, eb_r)
        eb_c = torch.where(can_shoot, alien_c0 + sc, state.eb_c)
        shot_count = state.shot_count + shoot_period.to(torch.int64)

        # Wave cleared -> a fresh block (the score keeps accumulating).
        cleared = (alive == 0).all(2).all(1)
        alive = torch.where(cleared[:, None, None], 1, alive)
        alien_r0 = torch.where(cleared, 1, alien_r0)
        alien_c0 = torch.where(cleared, 2, alien_c0)
        adir = torch.where(cleared, 1, adir)

        next_state = SpaceInvadersState(
            state.generator, player_c, alive, alien_r0, alien_c0, adir, fb_r, fb_c, fb_live,
            eb_r, eb_c, eb_live, shot_count, state.t + 1, state.step_count + 1,
        )
        return self._timestep(next_state, reward, shot_down | invaded)
