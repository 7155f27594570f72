"""Population runner (counterpart of stoix_tpu/population/runner.py): P
ff_ppo agents with their own hyperparameters, dispatched by the unchanged
Anakin host loop (systems/runner.py::run_anakin_experiment).

Layout (P = population, U = update batch), JAX's PopulationState:

  members (an ff_ppo PPOLearnerState)   every leaf [P, ...]: params and
      optimizer moments [P, (U,) ...], the optimizer step counts [P] int64,
      env state and timestep [P, E, ...], observation statistics, β, and
      every generator as its state bytes, [P, bytes] uint8
  hparams[name] / fitness               [P] float32 (host tensors)
  updates_done / exploit_total          host ints
  pbt_generator                         one CPU generator (the PBT stream)

A window runs each member's window through the port's own `PPOLearner` on
views of row p (`MemberLayout.member`), with that member's lifted hparams
read once a window as host floats holding float32 values, then stacks the
members' states once (`MemberLayout.stack`). `torch.func.vmap` cannot carry
B1's launch (its wrapper hands `data_ptr()`s to ctypes) nor the learner's
generators and host counts, so the members run one after another: under
`system.multistep_impl: pallas` a population update is one B1 GAE launch a
member. At P = 1 with nothing lifted the member's learner is the plain one,
and the run is the plain ff_ppo run bit for bit (JAX's squeeze path).

Fitness, each window: the data-summed mean completed-episode return of the
window, the previous value where a member completed no episode. PBT
(population/pbt.py) runs after the window's learn step. The evaluator serves
the argmax-fitness member (replica 0; the first of equal maxima).

Members over ranks (`arch.mesh.pop` = N, a ("pop", "data") mesh): the rank
at pop index k holds members k·P/N to (k + 1)·P/N − 1 with their own
seeds, so the run is the same population as on one rank. Each window the
fitness, episode and train metrics of every member are gathered over the
"pop" group; PBT selects alike on every rank from the whole fitness and
moves an exploited member's source rows from the rank that holds them
(pbt.py); the evaluator takes the global argmax member, broadcast from its
rank.

Seeds: member 0 takes the run's own (init, env, step) seeds, members p > 0
those of `anakin.group_member_seed(seed, p)` (the port's fold_in), and a
lifted `arch.seed` gives member p the seeds a plain run with
`arch.seed=seed_p` takes. The PBT stream is seeded from (seed, 0x5B7).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ExperimentOutput
from stoix_tpu_torch.observability import RunStats, get_logger
from stoix_tpu_torch.parallel import fetch_global, is_coordinator, mesh_shape, process_count
from stoix_tpu_torch.population import hparams as hparams_lib
from stoix_tpu_torch.population import pbt as pbt_lib
from stoix_tpu_torch.resilience.integrity import per_rank_fields
from stoix_tpu_torch.systems import anakin
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.checkpointing import _children, flatten_state
from stoix_tpu_torch.utils.tree import tree_leaves, tree_map, tree_stack

PBT_SEED_SALT = 0x5B7


class PopulationState(NamedTuple):
    """The whole population as one tree: the stacked member learner states
    beside the lifted hparams, fitness and the PBT bookkeeping."""

    members: Any  # ff_ppo.PPOLearnerState, every leaf with a leading [P] (this rank's)
    hparams: Dict[str, torch.Tensor]  # name -> [P] float32
    fitness: torch.Tensor  # [P] float32; -inf until a member completes an episode
    updates_done: int  # windows run
    pbt_generator: torch.Generator  # the coins and the clones' fresh seeds
    exploit_total: int  # members exploited so far

    def rank_bound_paths(self) -> set:
        """The subtrees each rank holds for itself (integrity.per_rank_fields,
        read by the fleet's rescue snapshot and the elastic restores): the
        members' env state, timestep and step streams; every member leaf
        when this rank holds only some of the members (a pop mesh). The
        hparams, fitness and PBT stream are the same on every rank."""
        if int(tree_leaves(self.members)[0].shape[0]) != int(self.fitness.shape[0]):
            return {"members"}
        return {f"members/{name}" for name in per_rank_fields(self.members)}


# Stats of the most recent run_population_experiment in this process:
# population_size, pbt_enabled, member_fitness [P], hparams {name: [P]},
# pbt_exploits and windows; host values, read at the run's end.
LAST_POPULATION_STATS = RunStats()


class MemberLayout:
    """How one member's learner state stacks into [P]-leading leaves and
    back, from a template member: tensors stack; a generator stacks as its
    state bytes and comes back as a generator on its device (one generator
    for every path that held the same one, as the env state's reset
    generator sits at two); a host int (the optimizer's step count) stacks
    as an int64 tensor and comes back as an int."""

    def __init__(self, template: Any):
        self.kinds: Dict[tuple, str] = {}
        self.devices: Dict[tuple, torch.device] = {}
        self.alias: Dict[tuple, tuple] = {}
        first: Dict[int, tuple] = {}
        for path, leaf in flatten_state(template):
            if isinstance(leaf, torch.Generator):
                self.kinds[path] = "generator"
                self.alias[path] = first.setdefault(id(leaf), path)
                self.devices[path] = leaf.device
            elif isinstance(leaf, torch.Tensor):
                self.kinds[path] = "tensor"
            elif leaf is None:
                self.kinds[path] = "none"
            elif isinstance(leaf, (bool, int)):
                self.kinds[path] = "int"
            else:
                raise TypeError(f"member leaf {'/'.join(path)}: {type(leaf).__name__} "
                                "has no stacked form")

    def stack(self, members: List[Any]) -> Any:
        """P member states to one state with [P]-leading leaves."""

        def leaf(path: tuple, values: List[Any]) -> Any:
            kind = self.kinds[path]
            if kind == "tensor":
                return torch.stack(values)
            if kind == "generator":
                return torch.stack([g.get_state() for g in values])
            if kind == "int":
                return torch.tensor([int(v) for v in values], dtype=torch.int64)
            return None

        return zip_map(leaf, members)

    def member(self, stacked: Any, p: int) -> Any:
        """Member p's learner state: views of row p, its generators rebuilt."""
        made: Dict[tuple, torch.Generator] = {}

        def leaf(path: tuple, values: List[Any]) -> Any:
            kind, value = self.kinds[path], values[0]
            if kind == "tensor":
                return value[p]
            if kind == "generator":
                canonical = self.alias[path]
                if canonical not in made:
                    generator = torch.Generator(device=self.devices[canonical])
                    generator.set_state(value[p].clone())
                    made[canonical] = generator
                return made[canonical]
            if kind == "int":
                return int(value[p])
            return None

        return zip_map(leaf, [stacked])


def zip_map(fn: Callable[[tuple, List[Any]], Any], trees: List[Any], prefix: tuple = ()) -> Any:
    """fn(path, [leaf of each tree]) over matching trees of records, dicts
    and sequences, rebuilding the first's structure; the paths and leaves
    are `utils/checkpointing.py::flatten_state`'s."""
    ref = trees[0]
    if isinstance(ref, (torch.Tensor, torch.Generator)) or _children(ref) is None:
        return fn(prefix, trees)
    if hasattr(ref, "_fields"):
        return type(ref)(*(zip_map(fn, [getattr(t, f) for t in trees], prefix + (f,))
                           for f in ref._fields))
    if isinstance(ref, dict):
        return {k: zip_map(fn, [t[k] for t in trees], prefix + (str(k),)) for k in ref}
    return type(ref)(zip_map(fn, [t[i] for t in trees], prefix + (str(i),))
                     for i in range(len(ref)))


def _validate_population_config(config: Any) -> Dict[str, int]:
    """The JAX package's refusals (its runner.py:76-96), with its messages;
    returns the mesh's axis sizes."""
    axes = dict(config.arch.get("mesh") or {"data": -1})
    shape = mesh_shape(axes, process_count())
    if "pop" not in shape:
        raise hparams_lib.PopulationConfigError(
            f"population training needs a 'pop' mesh axis; arch.mesh declares "
            f"{shape} — compose with arch=population (or add pop "
            "to arch.mesh)"
        )
    if bool(((config.get("arch") or {}).get("integrity") or {}).get("enabled", False)):
        raise hparams_lib.PopulationConfigError(
            "arch.integrity.enabled=true is not supported under population "
            "training yet: the sentinel's replica fingerprints assume "
            "replicated state, but population members are SHARDED over the "
            "pop axis — use arch.population.member_fingerprints plus "
            "population.pbt.quarantine_members (docs/DESIGN.md §2.11)"
        )
    if bool(config.arch.get("fused_eval", False)):
        raise hparams_lib.PopulationConfigError(
            "arch.fused_eval is not supported under population training (the "
            "evaluator serves the argmax-fitness member, selected per window)"
        )
    return shape


def member_seed(seed: int, p: int, seeds: Optional[np.ndarray]) -> int:
    """The setup seed member p splits into its (init, env, step) seeds."""
    if seeds is not None:
        return anakin.make_seeds(int(seeds[p]), 2)[0]  # the runner's split of arch.seed
    return int(seed) if p == 0 else anakin.group_member_seed(seed, p)


def best_member(fitness: torch.Tensor) -> int:
    """The fittest member (non-finite ranks last; the first of equal maxima)."""
    return int(torch.argmax(pbt_lib.ranked_fitness(fitness)))


def window_fitness(episode_metrics: Dict[str, torch.Tensor], previous: torch.Tensor,
                   group: Any) -> torch.Tensor:
    """Each member's mean completed-episode return over the window, summed
    over the data ranks first; the previous value where it completed none."""
    ret = episode_metrics["episode_return"]
    mask = episode_metrics["is_terminal_step"].to(torch.float32)
    pop_size = ret.shape[0]
    total = (ret * mask).reshape(pop_size, -1).sum(1)
    count = mask.reshape(pop_size, -1).sum(1)
    total, count = anakin.data_sum((total, count), group, kind="fitness")
    fitness = total / torch.clamp(count, min=1.0)
    return torch.where(count.cpu() > 0, fitness.cpu(), previous)


def gather_members(tree: Any, mesh: Any) -> Any:
    """Every member's rows of a tree of this rank's [P_local]-leading tensors,
    gathered over the mesh's "pop" axis in rank order (the tree itself off a
    pop mesh)."""
    if mesh is None:
        return tree
    return tree_map(lambda x, everyone: torch.from_numpy(everyone).to(x.device), tree,
                    fetch_global(tree, mesh, axis="pop", dim=0))


def member_row(tree: Any, member: int, offset: int, group: Any) -> Any:
    """Member `member`'s row of every tensor of a tree of this rank's
    [P_local]-leading tensors, on every rank: broadcast over the "pop" group
    from the rank that holds it."""
    if group is None:
        return tree_map(lambda x: x[member - offset], tree)
    leaves = tree_leaves(tree)
    p_local = int(leaves[0].shape[0])
    owner = member // p_local
    rows = ([x[member - offset] for x in leaves] if owner == dist.get_rank(group)
            else [torch.empty_like(x[0]) for x in leaves])
    placed = iter(pbt_lib.broadcast_rows(rows, dist.get_global_rank(group, owner), group))
    return tree_map(lambda _: next(placed), tree)


class PopulationLearner:
    """`learner(state) -> ExperimentOutput`: one window of each of this
    rank's members (rows `offset` on of the population), the fitness, then
    PBT."""

    def __init__(self, env: envs.Environment, apply_fns, update_fns, config: Any,
                 layout: MemberLayout, pbt_step: Optional[Callable] = None,
                 fingerprint_members: bool = False, offset: int = 0, pop_mesh: Any = None):
        self.env, self.apply_fns, self.update_fns = env, apply_fns, update_fns
        self.config = config
        self.layout = layout
        self.pbt_step = pbt_step
        self.fingerprint_members = fingerprint_members
        self.offset, self.pop_mesh = offset, pop_mesh
        self.plain = ff_ppo.get_learner_fn(env, apply_fns, update_fns, config)

    def member_hparams(self, state: PopulationState) -> List[Dict[str, float]]:
        """Each member's lifted hparams as host floats (float32 values), the
        whole population's."""
        columns = {name: v.tolist() for name, v in state.hparams.items()}
        return [{name: values[p] for name, values in columns.items()}
                for p in range(int(state.fitness.shape[0]))]

    def member_learner(self, hparams: Dict[str, float]) -> ff_ppo.PPOLearner:
        """The ff_ppo learner of a member with these lifted hparams (the
        plain learner when nothing is lifted)."""
        if not hparams:
            return self.plain
        return ff_ppo.get_learner_fn(self.env, self.apply_fns, self.update_fns, self.config,
                                     hparams=hparams)

    def __call__(self, state: PopulationState) -> ExperimentOutput:
        hparams = self.member_hparams(state)
        outs = []
        for p in range(int(tree_leaves(state.members)[0].shape[0])):
            member = self.layout.member(state.members, p)
            outs.append(self.member_learner(hparams[self.offset + p])(member))
        members = self.layout.stack([out.learner_state for out in outs])
        local = {
            "episodes": tree_stack([out.episode_metrics for out in outs]),
            "train": dict(tree_stack([out.train_metrics for out in outs])),
        }
        previous = state.fitness.narrow(0, self.offset, len(outs))
        local["fitness"] = window_fitness(local["episodes"], previous, self.plain.data_group)
        if self.fingerprint_members:
            local["train"]["member_fingerprint"] = torch.from_numpy(
                pbt_lib.member_fingerprints(members.params).astype(np.float64))
        everyone = gather_members(local, self.pop_mesh)
        fitness, episode_metrics = everyone["fitness"], everyone["episodes"]
        new_state = state._replace(members=members, fitness=fitness,
                                   updates_done=int(state.updates_done) + 1)
        train_metrics = everyone["train"]
        train_metrics["member_fitness"] = fitness
        if self.pbt_step is not None:
            new_state = self.pbt_step(new_state)
        return ExperimentOutput(learner_state=new_state, episode_metrics=episode_metrics,
                                train_metrics=train_metrics)


def population_setup(env: envs.Environment, config: Any, device: torch.device,
                     seed: int) -> AnakinSetup:
    """The population's learner state and learner, in the AnakinSetup
    contract, so systems/runner.py dispatches it as any single-agent one."""
    from stoix_tpu_torch.population import elastic as elastic_lib

    shape = _validate_population_config(config)
    pop_size, hp_arrays = hparams_lib.lift_hparams(config)
    pop_shards = int(shape["pop"])
    if pop_size % pop_shards != 0:
        raise hparams_lib.PopulationConfigError(
            f"arch.population.size ({pop_size}) must divide over the pop mesh "
            f"axis ({pop_shards} shard(s))"
        )
    pop_rank = anakin.pop_rank_and_size()[0]
    p_local = pop_size // pop_shards
    offset = pop_rank * p_local
    group = anakin.pop_group()
    learner_hp = hparams_lib.learner_hparams(hp_arrays)
    lr_threaded = "actor_lr" in learner_hp or "critic_lr" in learner_hp
    if lr_threaded and bool(config.system.get("decay_learning_rates", False)):
        raise hparams_lib.PopulationConfigError(
            "system.decay_learning_rates cannot combine with a lifted "
            "actor_lr/critic_lr: per-member learning rates are flat scalars"
        )

    # Each member's initial state is the plain setup's from its own seeds.
    seeds = hp_arrays.get("seed")
    setups = [ff_ppo._setup(env, config, device,
                            anakin.make_seeds(member_seed(seed, p, seeds), 3), None)
              for p in range(offset, offset + p_local)]
    template = setups[0].learn
    layout = MemberLayout(setups[0].learner_state)
    pop_state = PopulationState(
        members=layout.stack([s.learner_state for s in setups]),
        hparams={k: torch.from_numpy(np.array(v, dtype=v.dtype)) for k, v in learner_hp.items()},
        fitness=torch.full((pop_size,), -float("inf"), dtype=torch.float32),
        updates_done=0,
        pbt_generator=anakin.make_generator(anakin.group_member_seed(seed, PBT_SEED_SALT),
                                            torch.device("cpu")),
        exploit_total=0,
    )
    settings = pbt_lib.settings_from_config(config)
    pop_cfg = (config.get("arch") or {}).get("population") or {}
    learner = PopulationLearner(
        env, (template.actor_apply, template.critic_apply),
        (template.actor_optim, template.critic_optim), config, layout,
        pbt_step=(pbt_lib.make_pbt_step(settings, pop_size, offset, group)
                  if settings.enabled else None),
        fingerprint_members=bool(pop_cfg.get("member_fingerprints", False)),
        offset=offset, pop_mesh=anakin.pop_mesh(),
    )
    update_batch = int(config.arch.get("update_batch_size", 1))

    def row(tree: Any, best: int) -> Any:
        tree = member_row(tree, best, offset, group)
        return tree if update_batch == 1 else tree_map(lambda x: x[0], tree)

    if template.normalize_obs:
        def eval_params_fn(state: PopulationState):
            best = best_member(state.fitness)
            return (row(state.members.params.actor_params, best),
                    member_row(state.members.obs_stats, best, offset, group))
    else:
        def eval_params_fn(state: PopulationState):
            return row(state.members.params.actor_params, best_member(state.fitness))

    if is_coordinator():
        get_logger("stoix_tpu_torch.population").info(
            "[population] %d member(s) | mesh %s | lifted hparams: %s | pbt %s",
            pop_size, shape, sorted(learner_hp) or "none", "on" if settings.enabled else "off")
    return AnakinSetup(
        learn=learner,
        learner_state=pop_state,
        eval_act_fn=setups[0].eval_act_fn,
        eval_params_fn=eval_params_fn,
        guarded=True,
        # An emergency store saved at another population size is re-placed
        # onto this one before placement; identity when the sizes agree.
        restore_transform=elastic_lib.raw_resize_transform(config),
    )


def run_population_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train a population through the Anakin host loop; returns the final
    eval episode-return mean (of the fittest member) and fills
    LAST_POPULATION_STATS. Runs on CUDA unless the caller asks for another
    device."""
    holder: Dict[str, Any] = {}

    def recording_setup(env, cfg, dev, seed):
        setup = population_setup(env, cfg, dev, seed)
        inner = setup.learn

        def learn(state):
            out = inner(state)
            holder["state"] = out.learner_state
            return out

        return setup._replace(learn=learn)

    final_return = run_anakin_experiment(config, recording_setup, device, outer_axes=("pop",))
    LAST_POPULATION_STATS.clear()
    LAST_POPULATION_STATS["population_size"] = hparams_lib.population_size(config)
    LAST_POPULATION_STATS["pbt_enabled"] = pbt_lib.settings_from_config(config).enabled
    if holder:
        state = holder["state"]
        LAST_POPULATION_STATS.update({
            "member_fitness": [float(v) for v in state.fitness.tolist()],
            "hparams": {k: [float(v) for v in a.tolist()] for k, a in state.hparams.items()},
            "pbt_exploits": int(state.exploit_total),
            "windows": int(state.updates_done),
        })
    return final_return


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/population/default_ff_ppo.yaml", sys.argv[1:]
    )
    return run_population_experiment(config)


if __name__ == "__main__":
    main()
