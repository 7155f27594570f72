"""Environment factory (counterpart of stoix_tpu/envs/registry.py)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from stoix_tpu_torch.envs import (
    breakout_pixel, classic, debug, doorkey, game2048, locomotion, minatar, snake,
)
from stoix_tpu_torch.envs.core import Environment
from stoix_tpu_torch.parallel.distributed import process_count
from stoix_tpu_torch.envs.wrappers import (
    EpisodeStepLimit,
    FlattenObservationWrapper,
    RecordEpisodeMetrics,
    apply_core_wrappers,
)

# scenario name -> constructor(**env_kwargs)
ENV_REGISTRY: Dict[str, Callable[..., Environment]] = {
    "CartPole-v1": classic.CartPole,
    "Pendulum-v1": classic.Pendulum,
    "Acrobot-v1": classic.Acrobot,
    "MountainCar-v0": classic.MountainCar,
    "MountainCarContinuous-v0": classic.MountainCarContinuous,
    "Catch-bsuite": classic.Catch,
    "Ant": locomotion.Ant,
    "Hopper": locomotion.Hopper,
    "Walker2d": locomotion.Walker2d,
    "HalfCheetah": locomotion.HalfCheetah,
    "Breakout-minatar": minatar.Breakout,
    "Breakout-atari": breakout_pixel.BreakoutPixel,
    "Asterix-minatar": minatar.Asterix,
    "Freeway-minatar": minatar.Freeway,
    "SpaceInvaders-minatar": minatar.SpaceInvaders,
    "Snake-v1": snake.Snake,
    "Game2048-v1": game2048.Game2048,
    "DoorKey-v0": doorkey.DoorKey,
    "IdentityGame": debug.IdentityGame,
    "SequenceGame": debug.SequenceGame,
}


def register(name: str, ctor: Callable[..., Environment]) -> None:
    """Add (or replace) a scenario of the registry."""
    ENV_REGISTRY[name] = ctor


# The JAX package's external suites (its envs/suites.py SUITE_MAKERS): an
# `env.env_name` naming one builds that suite's adapter there, never the
# first-party env of the same scenario name, and the port has no adapters.
EXTERNAL_SUITES = ("gymnax", "brax", "jumanji", "popgym_arcade", "popjym", "craftax",
                   "xland_minigrid", "navix", "kinetix", "mujoco_playground", "jaxarc")


def make_single(scenario: str, suite: Optional[str] = None, **env_kwargs: Any) -> Environment:
    """Construct a raw (unwrapped) batched environment. `suite` is the
    config's `env.env_name`; an external suite's name is refused."""
    if suite in EXTERNAL_SUITES:
        raise NotImplementedError(
            f"env.env_name={suite!r} names an external suite, which is not ported: the JAX "
            f"package builds its adapter for {scenario!r}, not the first-party env")
    if scenario not in ENV_REGISTRY:
        raise NotImplementedError(
            f"env.scenario.name={scenario!r} is not ported; ported: {sorted(ENV_REGISTRY)}"
        )
    return ENV_REGISTRY[scenario](**env_kwargs)


def make(config: Any) -> Tuple[Environment, Environment]:
    """Build (train_env, eval_env) from a config with an `env` section.

    Config fields:
        env.scenario.name        — registry key
        env.env_name             — the suite (an external one is refused)
        env.kwargs               — ctor kwargs (optional)
        env.wrapper              — max_episode_steps, flatten_observation,
                                   use_optimistic_reset (with reset_ratio),
                                   use_cached_auto_reset (all optional)
    """
    env_cfg = config.env
    kwargs = dict(env_cfg.get("kwargs") or {})
    scenario = env_cfg.scenario.name
    suite = env_cfg.get("env_name")
    wrapper_cfg = dict(env_cfg.get("wrapper") or {})
    train_env = make_single(scenario, suite, **kwargs)
    eval_env = make_single(scenario, suite, **kwargs)
    if wrapper_cfg.get("flatten_observation", False):
        train_env = FlattenObservationWrapper(train_env)
        eval_env = FlattenObservationWrapper(eval_env)
    train_env = apply_core_wrappers(
        train_env,
        # This process's share of the global envs (all of them in one process).
        num_envs=int(config.arch.total_num_envs) // process_count(),
        max_episode_steps=wrapper_cfg.get("max_episode_steps"),
        use_optimistic_reset=bool(wrapper_cfg.get("use_optimistic_reset", False)),
        reset_ratio=int(wrapper_cfg.get("reset_ratio", 16)),
        use_cached_auto_reset=bool(wrapper_cfg.get("use_cached_auto_reset", False)),
    )
    # Eval env: metrics + step limit only; episodes must genuinely end (no
    # auto-reset) because the evaluator runs each episode until its LAST step.
    if wrapper_cfg.get("max_episode_steps"):
        eval_env = EpisodeStepLimit(eval_env, wrapper_cfg["max_episode_steps"])
    return train_env, RecordEpisodeMetrics(eval_env)
