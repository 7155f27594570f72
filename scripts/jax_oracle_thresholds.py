#!/usr/bin/env python3
"""The learning oracles of chip_smoke.py's cont_learn, rec_learn,
rainbow_learn, r2d2_learn, sac_learn, vpg_learn, awr_learn, mpo_learn,
vmpo_learn, az_learn, mz_learn, spo_learn, disco_learn, catch_learn,
snake_learn, sebulba_ppo_learn, sebulba_impala_learn, population_learn and
Pendulum oracle phases, computed from the JAX package on the CPU:

    JAX_PLATFORMS=cpu python scripts/jax_oracle_thresholds.py [--seeds 42 1 2]
        [--oracles pendulum rec rainbow r2d2 sac reinforce awr mpo vmpo az mz spo disco
                   catch snake spo_continuous mpo_continuous vmpo_continuous
                   sebulba_ppo sebulba_impala sebulba_dqn sebulba_impact population]

- Pendulum: the mean return of uniform random actions over 4096 episodes of
  the JAX package's Pendulum-v1 (`jax.random` key 0), and the JAX package's
  ff_ppo_continuous final evaluation return under chip_smoke.py's PENDULUM
  overrides for each seed; the threshold is the midpoint of the random return
  and the first seed's.
- IdentityGame: the JAX package's rec_ppo final evaluation return under
  chip_smoke.py's REC_IDENTITY overrides for each seed, and its ff_rainbow
  and rec_r2d2 returns under SEQUENCE_IDENTITY's (the threshold there is
  the family's 8.0, which these show the reference reaches).
- SAC on Pendulum: the JAX package's ff_sac under chip_smoke.py's
  SAC_PENDULUM overrides for each seed; the threshold is the midpoint of
  the random return (as above) and the first seed's.
- REINFORCE and AWR on IdentityGame: the JAX package's ff_reinforce and
  ff_awr under VPG_IDENTITY and AWR_IDENTITY (threshold PG_THRESHOLD, 8.0).
- MPO and V-MPO on IdentityGame: the JAX package's ff_mpo and ff_vmpo under
  MPO_IDENTITY and VMPO_IDENTITY (threshold MPO_THRESHOLD: 8.0 where the
  JAX package reaches 10.0, else the midpoint of random actions' 2.5 and
  its return).
- AlphaZero and MuZero on IdentityGame at the sweep's 8 simulations: the
  JAX package's ff_az and ff_mz under AZ_IDENTITY and MZ_IDENTITY (threshold
  SEARCH_THRESHOLD by the same rule as MPO's).
- SPO and Disco-RL on IdentityGame: the JAX package's ff_spo and ff_disco103
  under SPO_IDENTITY and DISCO_IDENTITY (the same rule as MPO's). The JAX
  ff_disco103 reads its meta-params from a local npz this script writes (the
  grounded rule does not use them); a download is refused, never tried.
- ff_ppo with network=cnn on Catch (bsuite, 10x5x1 boards): the mean return
  of uniform random actions over 4096 episodes of the JAX package's Catch
  (`jax.random` key 0), and the JAX package's ff_ppo under chip_smoke.py's
  CATCH overrides for each seed; the threshold is the midpoint of the random
  return and the seeds' lowest.
- ff_ppo on Snake (6x6, flattened, the MLP networks): the mean return of
  uniform random legal actions over 4096 episodes of the JAX package's Snake
  (`jax.random` key 0; an episode ends at death or its 500-step limit), and
  the JAX package's ff_ppo under chip_smoke.py's SNAKE overrides for each
  seed; the threshold is the midpoint of the random return and the seeds'
  lowest.
- Sebulba ff_ppo and ff_impala on IdentityGame: the JAX package's Sebulba
  systems under chip_smoke.py's SEBULBA_ORACLES overrides (every role on
  device 0), for each seed; the threshold is 8.0 where every seed returns
  10.0, else the midpoint of random actions' 2.5 and the seeds' lowest.
- SPO, MPO and V-MPO with continuous actions on Pendulum: the JAX package's
  ff_spo_continuous, ff_mpo_continuous and ff_vmpo_continuous under
  chip_smoke.py's PENDULUM_ORACLES overrides; the threshold is the midpoint
  of the random return (as above) and the first seed's.
- Population training on IdentityGame: the JAX package's population runner
  (4 ff_ppo members, ent_coef lifted, PBT every 2 windows) under
  chip_smoke.py's POPULATION_IDENTITY overrides, for each seed: the fittest
  member's final evaluation return; the threshold is 8.0 where every seed
  returns 10.0, else the midpoint of random actions' 2.5 and the seeds'
  lowest.

`--extra o1 o2 ...` appends overrides to every run (a larger budget to try;
later overrides win over the oracle's own).

Prints one JSON line. The JAX runs take about a minute each on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import urllib.request

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from stoix_tpu.envs.classic import Catch, Pendulum  # noqa: E402
from stoix_tpu.envs.snake import Snake  # noqa: E402
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


EXTRA: list = []  # --extra: overrides appended to every run (a budget to try)


def random_catch_return(episodes: int) -> float:
    env = Catch()

    def episode(key):
        reset_key, act_key = jax.random.split(key)
        state, _ = env.reset(reset_key)

        def step(carry, k):
            state, ret, done = carry
            state, ts = env.step(state, jax.random.randint(k, (), 0, 3))
            return (state, ret + jnp.where(done, 0.0, ts.reward), done | ts.last()), None

        # A Catch episode is rows - 1 = 9 steps long.
        (_, ret, _), _ = jax.lax.scan(step, (state, jnp.zeros(()), jnp.zeros((), bool)),
                                      jax.random.split(act_key, 9))
        return ret

    keys = jax.random.split(jax.random.PRNGKey(0), episodes)
    return float(jnp.mean(jax.jit(jax.vmap(episode))(keys)))


def random_snake_return(episodes: int) -> float:
    """Uniform random legal actions on the 6x6 Snake of env=snake."""
    env = Snake(num_rows=6, num_cols=6)

    def episode(key):
        reset_key, act_key = jax.random.split(key)
        state, ts = env.reset(reset_key)

        def step(carry, k):
            state, ts, ret, done = carry
            action = jax.random.categorical(k, jnp.log(ts.observation.action_mask))
            state, ts = env.step(state, action)
            return (state, ts, ret + jnp.where(done, 0.0, ts.reward), done | ts.last()), None

        (_, _, ret, _), _ = jax.lax.scan(
            step, (state, ts, jnp.zeros(()), jnp.zeros((), bool)), jax.random.split(act_key, 500))
        return ret

    keys = jax.random.split(jax.random.PRNGKey(0), episodes)
    return float(jnp.mean(jax.jit(jax.vmap(episode))(keys)))


def final_return(module: str, root: str, overrides: list, seed: int,
                 entry: str = "run_experiment") -> dict:
    import importlib

    overrides = [o for o in overrides if not o.startswith("system.multistep_impl")] + EXTRA
    config = config_lib.compose(config_lib.default_config_dir(), root,
                                overrides + [f"arch.seed={seed}"])
    start = time.perf_counter()
    ret = getattr(importlib.import_module(module), entry)(config)
    return {"seed": seed, "final_return": float(ret), "seconds": time.perf_counter() - start}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[42])
    parser.add_argument("--episodes", type=int, default=4096)
    oracles = ["pendulum", "rec", "rainbow", "r2d2", "sac", "reinforce", "awr", "mpo", "vmpo",
               "az", "mz", "spo", "disco", "catch", "snake", *chip_smoke.PENDULUM_ORACLES,
               *chip_smoke.SEBULBA_ORACLES, "population"]
    parser.add_argument("--oracles", nargs="+", default=oracles, choices=oracles)
    parser.add_argument("--extra", nargs="*", default=[],
                        help="overrides appended to every run, e.g. a budget to try")
    args = parser.parse_args()
    EXTRA.extend(args.extra)
    out = {"extra_overrides": args.extra} if args.extra else {}
    if {"pendulum", "sac", *chip_smoke.PENDULUM_ORACLES} & set(args.oracles):
        random_return = random_pendulum_return(args.episodes)
        out["pendulum_random_return"] = random_return
    if "pendulum" in args.oracles:
        pendulum = [final_return("stoix_tpu.systems.ppo.anakin.ff_ppo_continuous",
                                 chip_smoke.CONT_ROOT, chip_smoke.PENDULUM, seed)
                    for seed in args.seeds]
        out.update({"pendulum_jax": pendulum,
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
    if "sac" in args.oracles:
        sac = [final_return("stoix_tpu.systems.sac.ff_sac", chip_smoke.AC_ROOTS["ff_sac"],
                            chip_smoke.SAC_PENDULUM, seed) for seed in args.seeds]
        out.update({"sac_pendulum_jax": sac,
                    "sac_threshold": (random_return + sac[0]["final_return"]) / 2,
                    "sac_overrides": chip_smoke.SAC_PENDULUM})
    for name, module, root, overrides in (
            ("reinforce", "stoix_tpu.systems.vpg.ff_reinforce", chip_smoke.VPG_ROOT,
             chip_smoke.VPG_IDENTITY),
            ("awr", "stoix_tpu.systems.awr.ff_awr", chip_smoke.AWR_ROOT, chip_smoke.AWR_IDENTITY)):
        if name in args.oracles:
            out[f"{name}_identity_jax"] = [final_return(module, root, overrides, seed)
                                           for seed in args.seeds]
            out[f"{name}_identity_overrides"] = overrides
            out["pg_threshold"] = chip_smoke.PG_THRESHOLD
    for name, overrides in (("mpo", chip_smoke.MPO_IDENTITY),
                            ("vmpo", chip_smoke.VMPO_IDENTITY)):
        if name in args.oracles:
            runs = [final_return(f"stoix_tpu.systems.mpo.ff_{name}",
                                 chip_smoke.MPO_ROOTS[f"ff_{name}"], overrides, seed)
                    for seed in args.seeds]
            first = runs[0]["final_return"]
            out.update({f"{name}_identity_jax": runs, f"{name}_identity_overrides": overrides,
                        f"{name}_threshold": 8.0 if first >= 10.0 else (2.5 + first) / 2})
    for name, overrides in (("az", chip_smoke.AZ_IDENTITY), ("mz", chip_smoke.MZ_IDENTITY)):
        if name in args.oracles:
            runs = [final_return(f"stoix_tpu.systems.search.ff_{name}",
                                 chip_smoke.SEARCH_ROOTS[f"ff_{name}"], overrides, seed)
                    for seed in args.seeds]
            first = runs[0]["final_return"]
            out.update({f"{name}_identity_jax": runs, f"{name}_identity_overrides": overrides,
                        f"{name}_threshold": 8.0 if first >= 10.0 else (2.5 + first) / 2})
    if "spo" in args.oracles:
        runs = [final_return("stoix_tpu.systems.spo.ff_spo", chip_smoke.SPO_ROOTS["ff_spo"],
                             chip_smoke.SPO_IDENTITY, seed) for seed in args.seeds]
        first = runs[0]["final_return"]
        out.update({"spo_identity_jax": runs, "spo_identity_overrides": chip_smoke.SPO_IDENTITY,
                    "spo_threshold": 8.0 if first >= 10.0 else (2.5 + first) / 2})
    if "disco" in args.oracles:
        runs = disco_returns(args.seeds)
        first = runs[0]["final_return"]
        out.update({"disco_identity_jax": runs,
                    "disco_identity_overrides": chip_smoke.DISCO_IDENTITY,
                    "disco_threshold": 8.0 if first >= 10.0 else (2.5 + first) / 2})
    if "catch" in args.oracles:
        random_catch = random_catch_return(args.episodes)
        runs = [final_return("stoix_tpu.systems.ppo.anakin.ff_ppo", chip_smoke.PPO_ROOT,
                             chip_smoke.CATCH, seed) for seed in args.seeds]
        lowest = min(run["final_return"] for run in runs)
        out.update({"catch_random_return": random_catch, "catch_jax": runs,
                    "catch_overrides": chip_smoke.CATCH,
                    "catch_threshold": (random_catch + lowest) / 2})
    if "snake" in args.oracles:
        random_snake = random_snake_return(args.episodes)
        runs = [final_return("stoix_tpu.systems.ppo.anakin.ff_ppo", chip_smoke.PPO_ROOT,
                             chip_smoke.SNAKE, seed) for seed in args.seeds]
        lowest = min(run["final_return"] for run in runs)
        out.update({"snake_random_return": random_snake, "snake_jax": runs,
                    "snake_overrides": chip_smoke.SNAKE,
                    "snake_threshold": (random_snake + lowest) / 2})
    for name, (system, root, overrides) in chip_smoke.PENDULUM_ORACLES.items():
        if name in args.oracles:
            package = "spo" if system.startswith("ff_spo") else "mpo"
            runs = [final_return(f"stoix_tpu.systems.{package}.{system}", root, overrides, seed)
                    for seed in args.seeds]
            out.update({f"{name}_pendulum_jax": runs, f"{name}_pendulum_overrides": overrides,
                        f"{name}_threshold": (random_return + runs[0]["final_return"]) / 2})
    for name, (system, overrides) in chip_smoke.SEBULBA_ORACLES.items():
        if name in args.oracles:
            package = {"ff_ppo": "ppo", "ff_dqn": "q_learning"}.get(system, "impala")
            runs = [final_return(f"stoix_tpu.systems.{package}.sebulba.{system}",
                                 chip_smoke.SEBULBA_ROOTS[system], overrides, seed)
                    for seed in args.seeds]
            lowest = min(run["final_return"] for run in runs)
            out.update({f"{name}_identity_jax": runs, f"{name}_identity_overrides": overrides,
                        f"{name}_threshold": 8.0 if lowest >= 10.0 else (2.5 + lowest) / 2})
    if "population" in args.oracles:
        runs = [final_return("stoix_tpu.population.runner", chip_smoke.POPULATION_ROOT,
                             chip_smoke.POPULATION_IDENTITY, seed,
                             entry="run_population_experiment")
                for seed in args.seeds]
        lowest = min(run["final_return"] for run in runs)
        out.update({"population_identity_jax": runs,
                    "population_identity_overrides": chip_smoke.POPULATION_IDENTITY,
                    "population_threshold": 8.0 if lowest >= 10.0 else (2.5 + lowest) / 2})
    print(json.dumps(out))


def disco_returns(seeds: list) -> list:
    """The JAX ff_disco103 under DISCO_IDENTITY, its meta-params read from a
    local npz (its grounded rule does not use them): the package's loader
    would otherwise try a download, which is refused here."""
    import numpy as np

    from stoix_tpu.systems.disco import update_rule

    def refuse(*args, **kwargs):
        raise RuntimeError("no download: the oracle reads its meta-params from a local file")

    urllib.request.urlretrieve = refuse
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "meta.npz")
        rule = update_rule.DiscoUpdateRule(num_actions=4, num_bins=51)
        np.savez(path, **update_rule.flatten_meta_params(rule.init_params(jax.random.PRNGKey(0))))
        return [final_return("stoix_tpu.systems.disco.ff_disco103", chip_smoke.DISCO_ROOT,
                             chip_smoke.DISCO_IDENTITY + [f"system.meta_params_path={path}"],
                             seed) for seed in seeds]


if __name__ == "__main__":
    main()
