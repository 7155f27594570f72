"""Hyperparameter lifting for population training (counterpart of
stoix_tpu/population/hparams.py: the same liftable keys, messages and
dtypes). It turns

    arch:
      population:
        size: 8
        hparams:
          system.ent_coef: [0.0, 0.001, 0.003, 0.01, 0.01, 0.03, 0.1, 0.3]
          system.actor_lr: 3.0e-4          # scalar = broadcast to all members

into `{short_name: np.ndarray[P]}` arrays that the population runner keeps in
its state and hands each member's learner as host floats
(`ff_ppo.get_learner_fn(..., hparams=...)`). Only LIFTABLE leaves (scalars
the learner reads each update, not shape knobs) may vary per member;
`epochs`, `num_minibatches` and `rollout_length` change the program's shapes
and stay one value for the whole population.

`arch.seed` is special: it does not reach the learner at all. It reseeds
each member's streams at setup (member p trains from seed_p, as a plain run
with `arch.seed=seed_p` would). Without it member 0 keeps the run's own
seeds (the population-of-1 pin) and members p > 0 derive theirs from
(seed, p).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

# Dotted config path -> the hparam name ff_ppo.get_learner_fn resolves.
LIFTABLE_HPARAMS: Dict[str, str] = {
    "system.actor_lr": "actor_lr",
    "system.critic_lr": "critic_lr",
    "system.gamma": "gamma",
    "system.gae_lambda": "gae_lambda",
    "system.clip_eps": "clip_eps",
    "system.ent_coef": "ent_coef",
    "system.vf_coef": "vf_coef",
    "system.reward_scale": "reward_scale",
    "arch.seed": "seed",
}

# Exploit/explore may multiply these; seeds are identities, never perturbed.
PERTURBABLE = frozenset(set(LIFTABLE_HPARAMS.values()) - {"seed"})


class PopulationConfigError(ValueError):
    """An arch.population block that cannot be lifted onto the pop axis."""


def population_size(config: Any) -> int:
    pop_cfg = (config.get("arch") or {}).get("population") or {}
    size = int(pop_cfg.get("size", 1) or 1)
    if size <= 0:
        raise PopulationConfigError(f"arch.population.size must be positive, got {size}")
    return size


def lift_hparams(config: Any) -> Tuple[int, Dict[str, np.ndarray]]:
    """Resolve arch.population into (P, {name: [P] array}).

    Every entry of arch.population.hparams must be a liftable dotted path
    mapping to either a scalar (broadcast) or a length-P list. Values are
    float32 (seed: int32), the dtypes the JAX package holds them in.
    """
    size = population_size(config)
    pop_cfg = (config.get("arch") or {}).get("population") or {}
    raw = dict(pop_cfg.get("hparams") or {})
    arrays: Dict[str, np.ndarray] = {}
    for dotted, values in raw.items():
        if dotted not in LIFTABLE_HPARAMS:
            raise PopulationConfigError(
                f"arch.population.hparams key '{dotted}' is not liftable onto "
                f"the pop axis — liftable leaves: "
                f"{', '.join(sorted(LIFTABLE_HPARAMS))}. Structural knobs "
                "(epochs, num_minibatches, rollout_length, network sizes) "
                "change program shapes and cannot vary per member."
            )
        name = LIFTABLE_HPARAMS[dotted]
        if isinstance(values, (int, float)):
            values = [values] * size
        values = list(values)
        if len(values) != size:
            raise PopulationConfigError(
                f"arch.population.hparams['{dotted}'] has {len(values)} "
                f"values for a population of {size} — give one scalar or "
                "exactly P values"
            )
        dtype = np.int32 if name == "seed" else np.float32
        arrays[name] = np.asarray(values, dtype=dtype)
    return size, arrays


def learner_hparams(arrays: Dict[str, Any]) -> Dict[str, Any]:
    """The subset handed to get_learner_fn (seed acts at setup only)."""
    return {k: v for k, v in arrays.items() if k != "seed"}
