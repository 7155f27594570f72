#!/usr/bin/env python3
"""The learning oracles of chip_smoke.py's cont_learn, rec_learn,
rainbow_learn and r2d2_learn phases, computed from the JAX package on the
CPU:

    JAX_PLATFORMS=cpu python scripts/jax_oracle_thresholds.py [--seeds 42 1 2]
        [--oracles pendulum rec rainbow r2d2]

- Pendulum: the mean return of uniform random actions over 4096 episodes of
  the JAX package's Pendulum-v1 (`jax.random` key 0), and the JAX package's
  ff_ppo_continuous final evaluation return under chip_smoke.py's PENDULUM
  overrides for each seed; the threshold is the midpoint of the random return
  and the first seed's.
- IdentityGame: the JAX package's rec_ppo final evaluation return under
  chip_smoke.py's REC_IDENTITY overrides for each seed, and its ff_rainbow
  and rec_r2d2 returns under SEQUENCE_IDENTITY's (the threshold there is
  the family's 8.0, which these show the reference reaches).

Prints one JSON line. The JAX runs take about a minute each on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from stoix_tpu.envs.classic import Pendulum  # noqa: E402
from stoix_tpu.utils import config as config_lib  # noqa: E402


def random_pendulum_return(episodes: int) -> float:
    env = Pendulum()

    def episode(key):
        reset_key, act_key = jax.random.split(key)
        state, _ = env.reset(reset_key)

        def step(carry, k):
            state, ret = carry
            action = jax.random.uniform(k, (1,), minval=-2.0, maxval=2.0)
            state, ts = env.step(state, action)
            return (state, ret + ts.reward), None

        (_, ret), _ = jax.lax.scan(step, (state, jnp.zeros(())), jax.random.split(act_key, 200))
        return ret

    keys = jax.random.split(jax.random.PRNGKey(0), episodes)
    return float(jax.jit(jax.vmap(episode))(keys).mean())


def final_return(module: str, root: str, overrides: list, seed: int) -> dict:
    import importlib

    overrides = [o for o in overrides if not o.startswith("system.multistep_impl")]
    config = config_lib.compose(config_lib.default_config_dir(), root,
                                overrides + [f"arch.seed={seed}"])
    start = time.perf_counter()
    ret = importlib.import_module(module).run_experiment(config)
    return {"seed": seed, "final_return": float(ret), "seconds": time.perf_counter() - start}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[42])
    parser.add_argument("--episodes", type=int, default=4096)
    parser.add_argument("--oracles", nargs="+", default=["pendulum", "rec", "rainbow", "r2d2"],
                        choices=["pendulum", "rec", "rainbow", "r2d2"])
    args = parser.parse_args()
    out = {}
    if "pendulum" in args.oracles:
        random_return = random_pendulum_return(args.episodes)
        pendulum = [final_return("stoix_tpu.systems.ppo.anakin.ff_ppo_continuous",
                                 chip_smoke.CONT_ROOT, chip_smoke.PENDULUM, seed)
                    for seed in args.seeds]
        out.update({"pendulum_random_return": random_return, "pendulum_jax": pendulum,
                    "pendulum_threshold": (random_return + pendulum[0]["final_return"]) / 2,
                    "pendulum_overrides": chip_smoke.PENDULUM})
    if "rec" in args.oracles:
        out.update({"rec_identity_jax": [
            final_return("stoix_tpu.systems.ppo.anakin.rec_ppo", chip_smoke.REC_ROOT,
                         chip_smoke.REC_IDENTITY, seed) for seed in args.seeds],
            "rec_identity_overrides": chip_smoke.REC_IDENTITY})
    for name, system in (("rainbow", "ff_rainbow"), ("r2d2", "rec_r2d2")):
        if name in args.oracles:
            out[f"{name}_identity_jax"] = [
                final_return(f"stoix_tpu.systems.q_learning.{system}",
                             chip_smoke.SEQUENCE_ROOTS[system],
                             chip_smoke.SEQUENCE_IDENTITY[system], seed)
                for seed in args.seeds]
            out[f"{name}_identity_overrides"] = chip_smoke.SEQUENCE_IDENTITY[system]
    if "rainbow" in args.oracles or "r2d2" in args.oracles:
        out["sequence_threshold"] = chip_smoke.SEQUENCE_THRESHOLD
    print(json.dumps(out))


if __name__ == "__main__":
    main()
