"""Population jobs for the gloo ranks of tests/torch_ring_worker.py
(tests/test_torch_population.py): each runs on every rank and returns numpy
results; `save_rescue` also writes the one-process store the ranks restore.
Like the worker, this module imports no JAX."""

from __future__ import annotations

import os

import numpy as np
import torch

from stoix_tpu_torch.population import runner as prun
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.checkpointing import Checkpointer, flatten_state


def state_leaves(state) -> dict:
    """Every leaf of a learner state by tree path as numpy (generators as
    their states, host ints as 0-d arrays; None leaves left out)."""
    out = {}
    for path, leaf in flatten_state(state):
        if leaf is None:
            continue
        if isinstance(leaf, torch.Generator):
            leaf = leaf.get_state()
        out["/".join(path)] = (leaf.detach().cpu().numpy().copy() if isinstance(leaf, torch.Tensor)
                               else np.asarray(leaf))
    return out


def population_config(overrides, size, hparams=None, pbt=None):
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             "default/population/default_ff_ppo.yaml", list(overrides))
    config_lib._set_dotted(cfg, "arch.population.size", size)
    if hparams:
        config_lib._set_dotted(cfg, "arch.population.hparams", hparams)
    if pbt:
        config_lib._set_dotted(cfg, "arch.population.pbt", pbt)
    return cfg


def population_run(mesh_for, overrides, size, hparams, pbt, cwd):
    """One `run_population_experiment` on the CPU: every window's state (this
    rank's members, the whole population's hparams and fitness), the final
    return and the population's stats."""
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    windows = []
    setup_fn = prun.population_setup

    def recording_setup(*args, **kwargs):
        setup = setup_fn(*args, **kwargs)
        learn = setup.learn

        def recorded(state):
            out = learn(state)
            windows.append(state_leaves(out.learner_state))
            return out

        return setup._replace(learn=recorded)

    prun.population_setup = recording_setup
    try:
        final = prun.run_population_experiment(population_config(overrides, size, hparams, pbt),
                                               device="cpu")
    finally:
        prun.population_setup = setup_fn
    return {"windows": windows, "final_return": final,
            "stats": dict(prun.LAST_POPULATION_STATS)}


def population_refusal(mesh_for, overrides, size, cwd):
    """The message `run_population_experiment` refuses the config with."""
    from stoix_tpu_torch.population.hparams import PopulationConfigError

    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        prun.run_population_experiment(population_config(overrides, size), device="cpu")
    except PopulationConfigError as error:
        return str(error)
    return None


def rescue_settings(directory):
    from stoix_tpu_torch.resilience import fleet

    return fleet.FleetSettings(enabled=True, heartbeat_interval_s=0.05, heartbeat_timeout_s=0.5,
                               monitor_poll_s=0.05, barrier_deadline_s=1.0, skew_warn_ratio=2.0,
                               exit_grace_s=0.0, emergency_dir=str(directory))


def save_rescue(state, directory, process_index=0, process_count=1):
    """`state` through the fleet's rescue snapshot (stage, confirm, save) as
    process `process_index` of `process_count`; returns its store's manifest.
    One process also saves it as step 64 of `directory/checkpoints/one`."""
    import json

    from stoix_tpu_torch.resilience import fleet

    coord = fleet.FleetCoordinator(rescue_settings(directory), backend=None,
                                   process_index=process_index, process_count=process_count,
                                   interrupt_on_partition=False)
    coord.stage_candidate(64, state)
    coord.confirm_candidate(64)
    if process_count == 1:
        Checkpointer("ff_ppo", rel_dir=os.path.join(directory, "checkpoints"),
                     checkpoint_uid="one").save(64, state, force=True)
    with open(os.path.join(coord.emergency_save(), fleet.MANIFEST_NAME)) as f:
        return json.load(f)


def population_rescue(mesh_for, axes, overrides, size, hparams, cwd, one_store=None):
    """A population's rescue store saved by every rank after one window and
    restored at the same world into a fresh setup (and, with `one_store`, a
    one-process rescue store and checkpoint, `one_store/checkpoints`,
    restored here): this rank's fresh template, its saved state, the store's
    partial keys and each restore, by tree path."""
    import torch.distributed as dist

    from stoix_tpu_torch import envs
    from stoix_tpu_torch.resilience import fleet
    from stoix_tpu_torch.systems import anakin
    from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps

    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    mesh_keys = [f"arch.mesh.{axis}={n}" for axis, n in axes.items()]
    cfg = check_total_timesteps(population_config(list(overrides) + mesh_keys, size, hparams),
                                axes["data"])
    env, _ = envs.make(cfg)
    with anakin.use_mesh(mesh_for(axes)):
        def fresh():
            return prun.population_setup(env, cfg, torch.device("cpu"), 5)

        def restore(path):
            template = fresh()
            restored, _ = fleet.restore_emergency(template.learner_state, path,
                                                  raw_transform=template.restore_transform)
            return state_leaves(restored)

        setup = fresh()
        state = setup.learn(setup.learner_state).learner_state
        manifest = save_rescue(state, os.path.join(cwd, "rescue"), dist.get_rank(),
                               dist.get_world_size())
        dist.barrier()
        out = {"saved": state_leaves(state), "partial": manifest["partial"],
               "fresh": state_leaves(fresh().learner_state),
               "restored": restore(os.path.join(cwd, "rescue"))}
        if one_store:
            out["from_one"] = restore(one_store)
            loader = Checkpointer("ff_ppo", rel_dir=os.path.join(one_store, "checkpoints"),
                                  checkpoint_uid="one")
            restored, _ = loader.restore(fresh().learner_state)
            out["checkpoint_from_one"] = state_leaves(restored)
            out["elastic_restore"] = loader.last_elastic_restore
    return out


POPULATION_KINDS = {"population_run": population_run, "population_refusal": population_refusal,
                    "population_rescue": population_rescue}
