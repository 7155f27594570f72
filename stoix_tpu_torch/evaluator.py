"""Evaluator (counterpart of stoix_tpu/evaluator.py: `get_distribution_act_fn`,
`get_ff_evaluator_fn`, `get_rnn_evaluator_fn`, `get_stateful_evaluator_fn`,
`evaluator_setup` and the evaluation-reset hooks `make_tiled_eval_reset_fn`
and `env.eval_reset_fn`).

All `num_eval_episodes` episodes run as ONE batch of envs. An episode that
has ended is frozen (its state and timestep no longer change) while the rest
run on, which is what the JAX evaluator's vmapped while-loop does. Without
`arch.eval_max_steps` the loop stops when every episode has ended; with it,
after exactly that many steps, and episodes still running at the cap report
their running return with `episode_finished` 0.

`env.eval_reset_fn` (a config target) replaces the eval env's reset for the
episodes: `hook(env, generator, episode_index)` with `episode_index` the
[N] global episode indices, returning the batched (state, timestep), as the
JAX package's three-argument hook does per episode. Its two-argument form
`hook(env, key)` resets one episode from a key and has no batched
counterpart: the port refuses it.

Over N data-parallel ranks the episodes are split as the JAX evaluator
shards them (stoix_tpu/evaluator.py:119-122): the global count rounded up to
a multiple of N, each rank running its contiguous share of the global
episode indices with its own generator. The evaluator returns this rank's
episodes; the runner gathers them (`parallel.fetch_global`), so every rank
sees the same global arrays.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Tuple

import torch

from stoix_tpu_torch.envs.core import Environment
from stoix_tpu_torch.envs.types import tree_select
from stoix_tpu_torch.systems.anakin import data_rank_and_size
from stoix_tpu_torch.utils.tree import tree_leaves, tree_map

# act_fn(params, observation, generator) -> action  (batched observation)
ActFn = Callable[[Any, Any, torch.Generator], torch.Tensor]
# rnn_act_fn(params, hstate, observation, done, generator) -> (hstate, action)
RnnActFn = Callable[[Any, Any, Any, torch.Tensor, torch.Generator], Tuple[Any, torch.Tensor]]


def get_distribution_act_fn(config: Any, actor_apply: Callable[..., Any]) -> ActFn:
    """Greedy (mode) or sampled acting from a distribution-returning network."""
    greedy = bool(config.arch.get("evaluation_greedy", False))

    def act(params: Any, observation: Any, generator: torch.Generator) -> torch.Tensor:
        dist = actor_apply(params, observation)
        return dist.mode() if greedy else dist.sample(generator)

    return act


ResetFn = Callable[[torch.Generator, int], Tuple[Any, Any]]


def rank_episodes(config: Any, eval_multiplier: int = 1) -> Tuple[int, int]:
    """(this rank's episode count, its first global episode index): the
    global `num_eval_episodes * eval_multiplier` rounded up to a multiple of
    the N data ranks, split evenly (all of them, from 0, in one process)."""
    rank, size = data_rank_and_size()
    episodes = int(config.arch.num_eval_episodes) * int(eval_multiplier)
    per_rank = -(-episodes // size)
    return per_rank, rank * per_rank


def _make_eval_reset_fn(eval_env: Environment, config: Any, first_episode: int = 0) -> ResetFn:
    """The episodes' reset: (generator, episodes) -> (state, timestep). The
    env's own reset unless `env.eval_reset_fn` names a hook, which gets the
    global indices of the episodes from `first_episode` on."""
    hook_cfg = config.env.get("eval_reset_fn")
    if not hook_cfg:
        return eval_env.reset
    from stoix_tpu_torch.utils.config import instantiate

    hook = instantiate(hook_cfg)
    if len(inspect.signature(hook).parameters) < 3:
        raise NotImplementedError(
            "env.eval_reset_fn: the port takes hook(env, generator, episode_index); the "
            "two-argument hook(env, key) resets one episode and has no batched counterpart")

    def reset(generator: torch.Generator, episodes: int):
        index = torch.arange(first_episode, first_episode + episodes, device=generator.device)
        return hook(eval_env, generator, index)

    return reset


def make_tiled_eval_reset_fn(levels: Any):
    """An eval-reset hook that cycles a fixed list of levels across episodes:
    episode i resets to level i % n_levels through the env's
    `reset_to_level(level, generator)`. `levels` is a sequence of per-level
    values (numbers, tensors, or trees of them) or one tree whose leaves have
    a leading level axis."""
    if isinstance(levels, (list, tuple)):
        stacked = tree_map(lambda *xs: torch.stack(xs), *(_tensors(level) for level in levels))
        n_levels = len(levels)
    else:
        stacked = levels
        n_levels = int(tree_leaves(levels)[0].shape[0])

    def hook(env: Environment, generator: torch.Generator, episode_index: torch.Tensor):
        slot = episode_index % n_levels
        level = tree_map(lambda x: x.to(slot.device)[slot], stacked)
        return env.reset_to_level(level, generator)

    return hook


def _tensors(tree: Any) -> Any:
    """A level as tensors: numbers and arrays converted, trees recursed."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tensors(x) for x in tree))
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def get_ff_evaluator_fn(
    eval_env: Environment, act_fn: ActFn, config: Any, eval_multiplier: int = 1
) -> Callable[[Any, torch.Generator], Dict[str, torch.Tensor]]:
    """Build the evaluator: (params, generator) -> episode metrics dict with
    tensors shaped [num_eval_episodes * eval_multiplier] (this rank's share
    over several ranks)."""
    episodes, first_episode = rank_episodes(config, eval_multiplier)
    reset_fn = _make_eval_reset_fn(eval_env, config, first_episode)
    eval_max_steps = config.arch.get("eval_max_steps")

    @torch.no_grad()
    def evaluator(params: Any, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        env_state, timestep = reset_fn(generator, episodes)
        steps = 0
        while True:
            finished = timestep.last()
            if eval_max_steps:
                if steps >= int(eval_max_steps):
                    break
            elif bool(finished.all()):  # one host sync per step
                break
            action = act_fn(params, timestep.observation, generator)
            stepped_state, stepped = eval_env.step(env_state, action)
            env_state = tree_select(finished, env_state, stepped_state)
            timestep = tree_select(finished, timestep, stepped)
            steps += 1
        metrics = timestep.extras["episode_metrics"]
        return {
            "episode_return": metrics["episode_return"],
            "episode_length": metrics["episode_length"],
            "episode_finished": timestep.last().to(torch.float32),
        }

    return evaluator


def get_rnn_evaluator_fn(
    eval_env: Environment,
    rnn_act_fn: RnnActFn,
    config: Any,
    init_hstate_fn: Callable[[int], Any],
    eval_multiplier: int = 1,
) -> Callable[[Any, torch.Generator], Dict[str, torch.Tensor]]:
    """Stateful evaluator: every episode carries its own state (an RNN's hidden
    state, or ff_trans_ppo's observation window) from `init_hstate_fn(episodes)`
    through its steps; `rnn_act_fn` gets the episode's `done` flag to clear it.
    As in the JAX evaluator each episode runs until it ends, and an episode
    that has ended is frozen, its state with it. Over several ranks each
    runs its share of the episodes, as `get_ff_evaluator_fn`."""
    episodes, first_episode = rank_episodes(config, eval_multiplier)
    reset_fn = _make_eval_reset_fn(eval_env, config, first_episode)

    @torch.no_grad()
    def evaluator(params: Any, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        env_state, timestep = reset_fn(generator, episodes)
        hstate = init_hstate_fn(episodes)
        while True:
            finished = timestep.last()
            if bool(finished.all()):  # one host sync per step
                break
            stepped_hstate, action = rnn_act_fn(
                params, hstate, timestep.observation, finished, generator
            )
            stepped_state, stepped = eval_env.step(env_state, action)
            hstate = tree_select(finished, hstate, stepped_hstate)
            env_state = tree_select(finished, env_state, stepped_state)
            timestep = tree_select(finished, timestep, stepped)
        metrics = timestep.extras["episode_metrics"]
        return {
            "episode_return": metrics["episode_return"],
            "episode_length": metrics["episode_length"],
        }

    return evaluator


def get_stateful_evaluator_fn(env_factory: Any, act_fn: ActFn, config: Any,
                              device: Any = "cpu"
                              ) -> Callable[[Any, torch.Generator], Dict[str, torch.Tensor]]:
    """The evaluator of a stateful env backend with no tensor-env twin (the
    gymnasium and envpool adapters): it drives one pool of
    `arch.num_eval_episodes` envs from the factory on the host until that
    many episodes conclude, at most `arch.eval_max_steps` (default 100 000)
    host steps, acting through `act_fn` on `device` (the evaluator's) with
    the observations moved there. It returns the metrics contract
    ({"episode_return": [episodes]}, float32 on the host); when no episode
    concludes, [nan], visible in the logs and never zero."""
    episodes_needed = int(config.arch.num_eval_episodes)
    envs = env_factory(episodes_needed)
    device = torch.device(device)
    max_host_steps = int(config.arch.get("eval_max_steps") or 0) or 100_000

    @torch.no_grad()
    def evaluator(params: Any, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        timestep = envs.reset()
        returns: list = []
        for _ in range(max_host_steps):
            if len(returns) >= episodes_needed:
                break
            observation = tree_map(lambda x: x.to(device), timestep.observation)
            action = act_fn(params, observation, generator)
            timestep = envs.step(action.cpu())
            metrics = timestep.extras["episode_metrics"]
            concluded = metrics["is_terminal_step"].to(torch.bool).cpu()
            returns.extend(metrics["episode_return"].cpu()[concluded].tolist())
        if not returns:
            returns = [float("nan")]
        return {"episode_return": torch.tensor(returns[:episodes_needed], dtype=torch.float32)}

    return evaluator


def evaluator_setup(eval_env: Environment, act_fn: ActFn, config: Any) -> Tuple[Any, Any]:
    """Returns (evaluator, absolute_metric_evaluator); the latter runs
    `arch.absolute_metric_multiplier` times as many episodes."""
    evaluator = get_ff_evaluator_fn(eval_env, act_fn, config)
    absolute_evaluator = get_ff_evaluator_fn(
        eval_env, act_fn, config,
        eval_multiplier=int(config.arch.get("absolute_metric_multiplier", 10)),
    )
    return evaluator, absolute_evaluator
