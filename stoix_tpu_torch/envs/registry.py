"""Environment factory (counterpart of stoix_tpu/envs/registry.py)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from stoix_tpu_torch.envs import classic, debug
from stoix_tpu_torch.envs.core import Environment
from stoix_tpu_torch.envs.wrappers import (
    EpisodeStepLimit,
    RecordEpisodeMetrics,
    apply_core_wrappers,
)

_UNPORTED_WRAPPERS = ("use_optimistic_reset", "use_cached_auto_reset", "flatten_observation")

# scenario name -> constructor(**env_kwargs)
ENV_REGISTRY: Dict[str, Callable[..., Environment]] = {
    "CartPole-v1": classic.CartPole,
    "IdentityGame": debug.IdentityGame,
}


def make_single(scenario: str, **env_kwargs: Any) -> Environment:
    """Construct a raw (unwrapped) batched environment."""
    if scenario not in ENV_REGISTRY:
        raise NotImplementedError(
            f"env.scenario.name={scenario!r} is not ported; ported: {sorted(ENV_REGISTRY)}"
        )
    return ENV_REGISTRY[scenario](**env_kwargs)


def make(config: Any) -> Tuple[Environment, Environment]:
    """Build (train_env, eval_env) from a config with an `env` section.

    Config fields:
        env.scenario.name        — registry key
        env.kwargs               — ctor kwargs (optional)
        env.wrapper              — dict(max_episode_steps) (optional; the JAX
                                   package's other wrapper keys raise)
    """
    env_cfg = config.env
    kwargs = dict(env_cfg.get("kwargs") or {})
    scenario = env_cfg.scenario.name
    wrapper_cfg = dict(env_cfg.get("wrapper") or {})
    unported = [f"env.wrapper.{k}" for k in _UNPORTED_WRAPPERS if wrapper_cfg.get(k, False)]
    if unported:
        raise NotImplementedError("not ported: " + ", ".join(unported))

    train_env = apply_core_wrappers(
        make_single(scenario, **kwargs), max_episode_steps=wrapper_cfg.get("max_episode_steps")
    )
    # Eval env: metrics + step limit only; episodes must genuinely end (no
    # auto-reset) because the evaluator runs each episode until its LAST step.
    eval_env = make_single(scenario, **kwargs)
    if wrapper_cfg.get("max_episode_steps"):
        eval_env = EpisodeStepLimit(eval_env, wrapper_cfg["max_episode_steps"])
    return train_env, RecordEpisodeMetrics(eval_env)
