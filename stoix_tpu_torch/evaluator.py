"""Evaluator (counterpart of stoix_tpu/evaluator.py: `get_distribution_act_fn`,
`get_ff_evaluator_fn` and `evaluator_setup`).

All `num_eval_episodes` episodes run as ONE batch of envs. An episode that
has ended is frozen (its state and timestep no longer change) while the rest
run on, which is what the JAX evaluator's vmapped while-loop does. Without
`arch.eval_max_steps` the loop stops when every episode has ended; with it,
after exactly that many steps, and episodes still running at the cap report
their running return with `episode_finished` 0.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from stoix_tpu_torch.envs.core import Environment
from stoix_tpu_torch.envs.types import tree_select

# act_fn(params, observation, generator) -> action  (batched observation)
ActFn = Callable[[Any, Any, torch.Generator], torch.Tensor]


def get_distribution_act_fn(config: Any, actor_apply: Callable[..., Any]) -> ActFn:
    """Greedy (mode) or sampled acting from a distribution-returning network."""
    greedy = bool(config.arch.get("evaluation_greedy", False))

    def act(params: Any, observation: Any, generator: torch.Generator) -> torch.Tensor:
        dist = actor_apply(params, observation)
        return dist.mode() if greedy else dist.sample(generator)

    return act


def get_ff_evaluator_fn(
    eval_env: Environment, act_fn: ActFn, config: Any, eval_multiplier: int = 1
) -> Callable[[Any, torch.Generator], Dict[str, torch.Tensor]]:
    """Build the evaluator: (params, generator) -> episode metrics dict with
    tensors shaped [num_eval_episodes * eval_multiplier]."""
    if config.env.get("eval_reset_fn"):
        raise NotImplementedError("env.eval_reset_fn is not ported")
    episodes = int(config.arch.num_eval_episodes) * int(eval_multiplier)
    eval_max_steps = config.arch.get("eval_max_steps")

    @torch.no_grad()
    def evaluator(params: Any, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        env_state, timestep = eval_env.reset(generator, episodes)
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


def evaluator_setup(eval_env: Environment, act_fn: ActFn, config: Any) -> Tuple[Any, Any]:
    """Returns (evaluator, absolute_metric_evaluator); the latter runs
    `arch.absolute_metric_multiplier` times as many episodes."""
    evaluator = get_ff_evaluator_fn(eval_env, act_fn, config)
    absolute_evaluator = get_ff_evaluator_fn(
        eval_env, act_fn, config,
        eval_multiplier=int(config.arch.get("absolute_metric_multiplier", 10)),
    )
    return evaluator, absolute_evaluator
