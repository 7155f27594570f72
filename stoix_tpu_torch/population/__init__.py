"""Population training (counterpart of stoix_tpu/population): P ff_ppo
agents with their own hyperparameters in one run, with PBT exploit/explore.

    hparams.py — lifts designated scalar config leaves (lr, ent_coef, gamma,
                 clip_eps, seed, ...) into [P] arrays, each member's learner
                 taking its row;
    pbt.py     — truncation selection as gathers and selects over the [P]
                 axis, the hparam perturbation, per-member fingerprints and
                 the survivor-reseed quarantine;
    runner.py  — the population setup and entry point over the unchanged
                 Anakin host loop (systems/runner.py);
    elastic.py — the population's shrink and grow across a relaunch, the
                 restore transform and the resize overrides.
"""

from stoix_tpu_torch.population.hparams import (
    LIFTABLE_HPARAMS,
    PopulationConfigError,
    lift_hparams,
    population_size,
)
from stoix_tpu_torch.population.pbt import (
    PBTSettings,
    member_fingerprints,
    quarantine_members,
    settings_from_config,
    truncation_selection,
)
from stoix_tpu_torch.population.runner import (
    LAST_POPULATION_STATS,
    PopulationState,
    population_setup,
    run_population_experiment,
)

__all__ = [
    "LIFTABLE_HPARAMS",
    "PopulationConfigError",
    "lift_hparams",
    "population_size",
    "PBTSettings",
    "member_fingerprints",
    "quarantine_members",
    "settings_from_config",
    "truncation_selection",
    "LAST_POPULATION_STATS",
    "PopulationState",
    "population_setup",
    "run_population_experiment",
]
