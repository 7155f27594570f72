"""Population shrink and grow across a different P (counterpart of
stoix_tpu/population/elastic.py: the same rules, messages and overrides).

The state half of the elastic resize protocol (resilience/elastic.py): when
a population run is relaunched at another topology, the PBT state the old
incarnation saved is re-placed onto the new population size, by PBT's own
rules (population/pbt.py) applied across incarnations:

  * **Shrink** keeps the fittest `new_size` members by the fitness the store
    RECORDED (non-finite ranks below every finite score), in their original
    order. Survivors' params, optimizer states, statistics, hparams and
    fitness move bit for bit: a shrink is a gather, never a recompute.
  * **Grow** keeps every existing member bit for bit and fills the new slots
    with clones of the fittest members, cyclically, each clone's perturbable
    hparams multiplied by float32(1 ± perturb_scale) by a coin and its step
    streams fresh: a clone explores, it never replays its source.
  * **Refusals**: below one member, or past `arch.population.max_size`,
    raise the typed ElasticResizeError; so does a store whose member rows
    are not one a member of its fitness (saved with the members spread over
    `arch.mesh.pop`, where each rank's members are its own and not stored).

The raw keys are the slash-joined tree paths of the port's PopulationState
(`members/...` and `hparams/...` with a leading [P], `fitness`, the host
ints `updates_done` and `exploit_total`, and `pbt_generator`, the PBT
stream's state bytes). The member streams are `members/generator` (a
[P, bytes] leaf, one a replica under `arch.update_batch_size`), JAX's
`members/key`. torch cannot reproduce `jax.random`, so the grow draws its
coins and the clones' fresh seeds from the stored PBT generator, coins first
(perturbable hparams in sorted order), then a seed a (clone slot, stream
leaf), and stores the advanced state; `coins` replaces the coin draws (a
test feeds JAX's).

Wired into the restore as `AnakinSetup.restore_transform`: the population
setup installs `raw_resize_transform(config)`, and
`fleet.restore_emergency` applies it to the digest-verified host arrays
before placement by tree path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from stoix_tpu_torch.observability import get_logger
from stoix_tpu_torch.population import hparams as hparams_lib
from stoix_tpu_torch.population import pbt as pbt_lib
from stoix_tpu_torch.resilience.elastic import ElasticResizeError

# Raw-store keys that carry a leading [P] population axis. The host ints
# (updates_done, exploit_total) and the PBT generator are not population leaves.
_POP_PREFIXES = ("members/", "hparams/")
_POP_EXACT = frozenset({"fitness"})
_FITNESS_KEY = "fitness"
_MEMBER_STREAM_LEAF = "members/generator"
_PBT_STREAM_LEAF = "pbt_generator"


def is_population_leaf(key: str) -> bool:
    return key in _POP_EXACT or any(key.startswith(p) for p in _POP_PREFIXES)


def _is_member_stream(key: str) -> bool:
    return key == _MEMBER_STREAM_LEAF or key.startswith(_MEMBER_STREAM_LEAF + "/")


def max_population_size(config: Any) -> Optional[int]:
    """`arch.population.max_size`, the configured grow ceiling (None/~ =
    uncapped)."""
    pop_cfg = (config.get("arch") or {}).get("population") or {}
    raw = pop_cfg.get("max_size")
    if raw in (None, ""):
        return None
    value = int(raw)
    if value < 1:
        raise hparams_lib.PopulationConfigError(
            f"arch.population.max_size must be positive, got {value}"
        )
    return value


def validate_resize(old_size: int, new_size: int, max_size: Optional[int] = None) -> None:
    """Never below one member, never past the configured max."""
    if new_size < 1:
        raise ElasticResizeError(
            f"cannot shrink the population below one member "
            f"(requested {new_size}, currently {old_size})"
        )
    if max_size is not None and new_size > max_size:
        raise ElasticResizeError(
            f"cannot grow the population to {new_size} members: "
            f"arch.population.max_size caps it at {max_size}"
        )


def _ranked(fitness: Any) -> np.ndarray:
    fitness = np.asarray(fitness, dtype=np.float64).reshape(-1)
    return np.where(np.isfinite(fitness), fitness, -np.inf)


def select_survivors(fitness: Any, new_size: int) -> np.ndarray:
    """Indices of the fittest `new_size` members by recorded fitness, in
    their original member order (a shrink re-indexes, it never reshuffles)."""
    fit = _ranked(fitness)
    old_size = int(fit.shape[0])
    validate_resize(old_size, new_size)
    if new_size > old_size:
        raise ElasticResizeError(
            f"select_survivors is a shrink: requested {new_size} of "
            f"{old_size} members"
        )
    order = np.argsort(fit, kind="stable")  # ascending: worst first
    return np.sort(order[old_size - new_size:])


def clone_sources(fitness: Any, old_size: int, new_size: int) -> np.ndarray:
    """Per-slot source index for a grow: existing slots are identities, new
    slots clone the fittest members cyclically, fittest first."""
    ranked = np.argsort(_ranked(fitness), kind="stable")[::-1]  # fittest first
    src = np.arange(new_size, dtype=np.int64)
    for i, slot in enumerate(range(old_size, new_size)):
        src[slot] = ranked[i % old_size]
    return src


def _explore_generator(raw: Dict[str, Any], old_size: int) -> torch.Generator:
    """The stored PBT stream, or (a store without it) one seeded from the
    old population size."""
    generator = torch.Generator()
    stored = raw.get(_PBT_STREAM_LEAF)
    if stored is None:
        generator.manual_seed(int(old_size))
    else:
        generator.set_state(torch.from_numpy(np.array(stored, dtype=np.uint8, order="C")))
    return generator


def resize_arrays(
    raw: Dict[str, np.ndarray],
    new_size: int,
    *,
    perturb_scale: float = 0.2,
    max_size: Optional[int] = None,
    coins: Optional[Dict[str, Any]] = None,
) -> Dict[str, np.ndarray]:
    """Resize every population leaf of a raw emergency-store dict to
    `new_size` members. Identity (the SAME dict) when the store is not a
    population store or already the right size, so the transform is safe to
    install unconditionally."""
    fitness = raw.get(_FITNESS_KEY)
    if fitness is None:
        return raw
    old_size = int(np.asarray(fitness).shape[0])
    if old_size == new_size:
        return raw
    validate_resize(old_size, new_size, max_size)
    rows = sorted({int(np.asarray(v).shape[0]) for k, v in raw.items()
                   if k.startswith(_POP_PREFIXES[0])})
    if rows != [old_size]:
        raise ElasticResizeError(
            f"cannot resize the population {old_size} -> {new_size}: the store "
            f"holds member rows {rows or 'none'}, not one a member of its fitness "
            f"(saved with the members spread over arch.mesh.pop, each rank's own); "
            f"relaunch at arch.population.size={old_size}"
        )
    log = get_logger("stoix_tpu_torch.population")
    out = dict(raw)
    if new_size < old_size:
        keep = select_survivors(fitness, new_size)
        for key, value in raw.items():
            if is_population_leaf(key):
                out[key] = np.ascontiguousarray(np.asarray(value)[keep])
        log.warning(
            "[elastic] population shrink %d -> %d: keeping members %s "
            "(fittest by recorded fitness)",
            old_size, new_size, keep.tolist(),
        )
        return out

    src = clone_sources(fitness, old_size, new_size)
    clone_slots = list(range(old_size, new_size))
    generator = _explore_generator(raw, old_size)
    names = sorted(k.split("/", 1)[1] for k in raw if k.startswith("hparams/"))
    drawn = pbt_lib.draw_coins(names, new_size, generator)
    if coins is not None:
        drawn = {name: torch.from_numpy(np.array(coins[name], dtype=bool)) for name in drawn}
    for key, value in raw.items():
        if is_population_leaf(key):
            out[key] = np.ascontiguousarray(np.asarray(value)[src])
    for key in sorted(k for k in out if k.startswith("hparams/")):
        name = key.split("/", 1)[1]
        if name in hparams_lib.PERTURBABLE:
            copied = out[key]
            factors = np.where(np.asarray(drawn[name]), np.float32(1.0 + perturb_scale),
                               np.float32(1.0 - perturb_scale)).astype(copied.dtype)
            for slot in clone_slots:
                copied[slot] = copied[slot] * factors[slot]
    streams = sorted(k for k in out if _is_member_stream(k))
    for slot in clone_slots:
        for key in streams:
            like = torch.from_numpy(np.array(out[key][slot]))
            out[key][slot] = pbt_lib.fresh_generator_state(
                like, pbt_lib.draw_seed(generator)).numpy()
    if _PBT_STREAM_LEAF in out:
        out[_PBT_STREAM_LEAF] = generator.get_state().numpy()
    log.warning(
        "[elastic] population grow %d -> %d: clone sources %s "
        "(fittest first, hparams perturbed x(1±%.3g), fresh streams)",
        old_size, new_size, [int(src[s]) for s in clone_slots], perturb_scale,
    )
    return out


def resize_population_state(state: Any, new_size: int, *, perturb_scale: float = 0.2,
                            max_size: Optional[int] = None) -> Any:
    """The in-process form of the resize: a PopulationState in, one with
    `new_size` members out, through exactly the raw transform the restore
    applies."""
    from stoix_tpu_torch.utils.checkpointing import flatten_state

    leaves = list(flatten_state(state))
    raw = {}
    for path, leaf in leaves:
        if leaf is None:
            continue
        if isinstance(leaf, torch.Generator):
            leaf = leaf.get_state()
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        raw["/".join(path)] = np.asarray(leaf)
    resized = resize_arrays(raw, new_size, perturb_scale=perturb_scale, max_size=max_size)

    def rebuild(path: tuple, leaf: Any) -> Any:
        if leaf is None:
            return None
        value = resized["/".join(path)]
        if isinstance(leaf, torch.Generator):
            generator = torch.Generator(device=leaf.device)
            generator.set_state(torch.from_numpy(np.array(value, order="C")))
            return generator
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(np.array(value, order="C")).to(leaf.device)
        return type(leaf)(np.asarray(value).item())

    from stoix_tpu_torch.population.runner import zip_map

    return zip_map(lambda path, values: rebuild(path, values[0]), [state])


def raw_resize_transform(config: Any) -> Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]:
    """The restore-time transform the population setup installs as
    `AnakinSetup.restore_transform`: re-places a store's members onto THIS
    config's population size (identity when they already agree)."""
    target = hparams_lib.population_size(config)
    scale = pbt_lib.settings_from_config(config).perturb_scale
    cap = max_population_size(config)

    def transform(raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return resize_arrays(raw, target, perturb_scale=scale, max_size=cap)

    return transform


def plan_population_size(config: Any, target_devices: int, from_devices: int) -> int:
    """The population size a relaunch at `target_devices` runs: scaled with
    the device ratio, floored at one member and clamped at
    `arch.population.max_size` (the transforms themselves refuse)."""
    size = hparams_lib.population_size(config)
    if from_devices < 1 or target_devices < 1:
        raise ElasticResizeError(
            f"cannot plan a population resize {from_devices} -> "
            f"{target_devices} device(s)"
        )
    new_size = max(1, (size * target_devices) // from_devices)
    cap = max_population_size(config)
    if cap is not None and new_size > cap:
        get_logger("stoix_tpu_torch.population").warning(
            "[elastic] grow to %d members clamped at arch.population."
            "max_size=%d", new_size, cap,
        )
        new_size = cap
    return new_size


def _resized_hparam_values(values: List[Any], fitness: Optional[List[float]],
                           new_size: int) -> List[Any]:
    """A per-member hparam list re-shaped for the new population: a shrink
    keeps the recorded-fitness survivors, a grow clones the fittest
    cyclically. Template values only: a restore overwrites them with the
    (perturbed) stored leaf."""
    old_size = len(values)
    fit = (
        np.asarray(fitness, dtype=np.float64)
        if fitness is not None and len(fitness) == old_size
        else np.zeros((old_size,), dtype=np.float64)
    )
    if new_size <= old_size:
        return [values[i] for i in select_survivors(fit, new_size)]
    return [values[int(i)] for i in clone_sources(fit, old_size, new_size)]


def population_resize_overrides(
    config: Any,
    *,
    target_devices: int,
    from_devices: Optional[int] = None,
    stats: Optional[Dict[str, Any]] = None,
) -> List[str]:
    """Config overrides re-deriving `arch.population` for a relaunch at
    `target_devices`: the scaled `size`, and re-shaped values for every
    per-member hparams LIST. `from_devices` defaults to this run's devices
    (the port's processes, one device each); `stats` to
    LAST_POPULATION_STATS, so the lists follow the recorded fitness the
    restore's selection will."""
    if from_devices is None:
        from stoix_tpu_torch.parallel import process_count

        from_devices = process_count()
    new_size = plan_population_size(config, target_devices, from_devices)
    overrides = [f"arch.population.size={new_size}"]
    if stats is None:
        from stoix_tpu_torch.population.runner import LAST_POPULATION_STATS

        stats = dict(LAST_POPULATION_STATS)
    fitness = stats.get("member_fitness")
    pop_cfg = (config.get("arch") or {}).get("population") or {}
    for dotted, values in dict(pop_cfg.get("hparams") or {}).items():
        if isinstance(values, (int, float)):
            continue  # scalars broadcast to any size
        resized = _resized_hparam_values(list(values), fitness, new_size)
        rendered = ",".join(repr(float(v)) for v in resized)
        overrides.append(f"arch.population.hparams.{dotted}=[{rendered}]")
    return overrides
