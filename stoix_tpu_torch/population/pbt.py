"""PBT exploit/explore over the stacked population (counterpart of
stoix_tpu/population/pbt.py).

Truncation selection (Jaderberg et al. 2017, arxiv 1711.09846) as gathers
and selects over the [P] axis of every member leaf. Every window the runner
updates each member's fitness (the data-summed mean completed-episode return
of that window); every `interval` windows the bottom `quantile` of members
copy the top quantile's params, optimizer state (its step count with it),
observation statistics, β and hparams exactly, then multiply the copied
perturbable hparams by (1 ± perturb_scale), one coin a (member, hparam), and
give the copied members fresh step streams so clones explore instead of
replaying their source.

Streams: the JAX package splits a PRNG key a window; torch cannot reproduce
`jax.random`, so the port keeps one CPU generator in the state
(`PopulationState.pbt_generator`) that draws the coins and the clones' fresh
seeds, and only in a window that fires. `perturb_hparams` and the step take
the coins as an argument, so a test can feed JAX's draws.

Members over ranks (`arch.mesh.pop` = N): a rank holds P/N members, rows
`offset` to `offset + P/N` of the population, beside the whole [P] fitness
and hparams; selection runs alike on every rank, and an exploited member
whose source another rank holds receives the source's rows (params,
optimizer states with the step count, statistics, β) by one broadcast from
that rank over the "pop" group.

Integrity composition: `member_fingerprints` folds each member's params to a
uint32 through resilience/integrity.py's position-salted murmur fold (the
JAX function of the same bytes, leaves in the JAX package's order: dict keys
sorted), and `quarantine_members` re-seeds corrupt members from the fittest
healthy survivor.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from stoix_tpu_torch.population.hparams import PERTURBABLE
from stoix_tpu_torch.resilience.integrity import fingerprint_leaves
from stoix_tpu_torch.utils.tree import tree_leaves, tree_map

# A CUDA generator's state: its seed (uint64), then its Philox offset (int64).
CUDA_GENERATOR_STATE_BYTES = 16


class PBTSettings(NamedTuple):
    enabled: bool
    interval: int  # windows between exploit/explore rounds
    quantile: float  # fraction exploited (bottom q copies top q)
    perturb_scale: float  # copied hparams multiply by (1 +- scale)


def settings_from_config(config: Any) -> PBTSettings:
    pop_cfg = (config.get("arch") or {}).get("population") or {}
    pbt_cfg = pop_cfg.get("pbt") or {}
    return PBTSettings(
        enabled=bool(pbt_cfg.get("enabled", False)),
        interval=max(1, int(pbt_cfg.get("interval", 1) or 1)),
        quantile=float(pbt_cfg.get("quantile", 0.25)),
        perturb_scale=float(pbt_cfg.get("perturb_scale", 0.2)),
    )


def ranked_fitness(fitness: torch.Tensor) -> torch.Tensor:
    """Fitness with every non-finite score (no completed episode yet, a
    diverged member) at -inf, below every finite one."""
    fitness = torch.as_tensor(fitness)
    return torch.where(torch.isfinite(fitness), fitness,
                       torch.full_like(fitness, -float("inf")))


def truncation_selection(fitness: torch.Tensor, pop_size: int,
                         quantile: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, is_bottom): member i copies from member src[i]; is_bottom marks
    the exploited (bottom-quantile) members. The sort is stable, as
    `jnp.argsort`, so tied members rank by their index; a NaN member is
    always an exploit target, never a source."""
    n = int(pop_size * quantile)
    n = max(1, n) if pop_size > 1 else 0
    src = torch.arange(pop_size, dtype=torch.int64)
    is_bottom = torch.zeros(pop_size, dtype=torch.bool)
    if n == 0:
        return src, is_bottom
    order = torch.argsort(ranked_fitness(fitness).cpu(), stable=True)  # worst first
    bottom, top = order[:n], order[pop_size - n:]
    src[bottom] = top
    is_bottom[bottom] = True
    return src, is_bottom


def broadcast_rows(rows: List[torch.Tensor], source: int, group: Any) -> List[torch.Tensor]:
    """`rows` as global rank `source` holds them, on every rank of `group`:
    their bytes in one broadcast (on the host unless the backend is NCCL)."""
    on_card = dist.get_backend(group) == "nccl"
    device = rows[0].device if on_card else torch.device("cpu")
    flat = torch.cat([(r.to(torch.uint8) if r.dtype == torch.bool else r.contiguous().reshape(
        -1).view(torch.uint8)).reshape(-1).to(device) for r in rows])
    dist.broadcast(flat, src=source, group=group)
    out, start = [], 0
    for r in rows:
        width = r.numel() * r.element_size()
        raw = flat[start:start + width]
        value = raw.to(torch.bool) if r.dtype == torch.bool else raw.clone().view(r.dtype)
        out.append(value.reshape(r.shape).to(r.device))
        start += width
    return out


def copy_rows(tree: Any, src: torch.Tensor, do: torch.Tensor, offset: int = 0,
              group: Any = None) -> Any:
    """where(do, x[src], x) over this rank's rows of every [P_local]-leading
    tensor of `tree` (rows `offset` on of the population; every row off a
    pop mesh): a source row another rank of the "pop" group holds comes from
    it by one broadcast. Reads the rows as they were before any copy."""
    leaves = tree_leaves(tree)
    p_local = int(leaves[0].shape[0])
    me = 0 if group is None else dist.get_rank(group)
    out = [x.clone() for x in leaves]
    for target in torch.nonzero(do).reshape(-1).tolist():
        source = int(src[target])
        source_rank, target_rank = source // p_local, target // p_local
        if source_rank == target_rank:
            if target_rank == me:
                for x, y in zip(leaves, out):
                    y[target - offset] = x[source - offset]
            continue
        rows = ([x[source - offset] for x in leaves] if source_rank == me
                else [torch.empty_like(x[0]) for x in leaves])
        rows = broadcast_rows(rows, dist.get_global_rank(group, source_rank), group)
        if target_rank == me:
            for y, row in zip(out, rows):
                y[target - offset] = row
    rebuilt = iter(out)
    return tree_map(lambda _: next(rebuilt), tree)


def fresh_generator_state(like: torch.Tensor, seed: int) -> torch.Tensor:
    """The state a generator of `like`'s kind takes from `manual_seed(seed)`,
    with no device at hand: a CUDA generator's is its seed and a zero
    offset, a CPU generator's its Mersenne Twister state."""
    if like.numel() == CUDA_GENERATOR_STATE_BYTES:
        return torch.from_numpy(np.array([seed, 0], dtype=np.uint64).view(np.uint8).copy())
    state = torch.Generator().manual_seed(int(seed)).get_state()
    if state.numel() != like.numel():
        raise ValueError(f"a generator state of {like.numel()} bytes is neither a CPU "
                         f"({state.numel()}) nor a CUDA ({CUDA_GENERATOR_STATE_BYTES}) one")
    return state


def draw_seed(generator: torch.Generator) -> int:
    """One 63-bit seed from the population generator."""
    return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator, dtype=torch.int64))


def resampled_streams(rows: Any, do: torch.Tensor, generator: torch.Generator,
                      offset: int = 0) -> Any:
    """Every [P, bytes] generator-state leaf of `rows` (the members' step
    streams, rows `offset` on of the population) with a fresh state for each
    member that `do` marks, its seed drawn from the population generator,
    members in order and each member's leaves in order; every rank draws the
    seeds of every member, so the generator stays the same on each."""
    leaves = tree_leaves(rows)
    fresh = [leaf.clone() for leaf in leaves]
    for member in torch.nonzero(do).reshape(-1).tolist():
        for leaf in fresh:
            seed = draw_seed(generator)
            if 0 <= member - offset < leaf.shape[0]:
                leaf[member - offset] = fresh_generator_state(leaf[member - offset], seed)
    rebuilt = iter(fresh)
    return tree_map(lambda _: next(rebuilt), rows)


def draw_coins(names: List[str], pop_size: int,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One fair coin a (member, perturbable hparam), hparams in sorted order."""
    return {name: torch.rand(pop_size, generator=generator) < 0.5
            for name in sorted(names) if name in PERTURBABLE}


def perturb_hparams(
    hparams: Dict[str, torch.Tensor],
    src: torch.Tensor,
    do: torch.Tensor,
    coins: Dict[str, torch.Tensor],
    scale: float,
) -> Dict[str, torch.Tensor]:
    """Copy each exploited member's hparams from its source, then multiply
    the perturbable ones by float32(1 + scale) where the member's coin is
    set and float32(1 - scale) where it is not, in float32."""
    out: Dict[str, torch.Tensor] = {}
    for name in sorted(hparams):
        v = hparams[name]
        copied = v.index_select(0, src.to(v.device))
        if name in PERTURBABLE:
            up = torch.tensor(np.float32(1.0 + scale), dtype=v.dtype)
            down = torch.tensor(np.float32(1.0 - scale), dtype=v.dtype)
            factors = torch.where(torch.as_tensor(coins[name]).to(v.device), up, down)
            copied = copied * factors
        out[name] = torch.where(do.to(v.device), copied, v)
    return out


def _copied_members(members: Any, src: torch.Tensor, do: torch.Tensor,
                    generator: torch.Generator, offset: int = 0, group: Any = None) -> Any:
    """The rows that follow their source (params, optimizer states with the
    step count, observation statistics, β) copied; the step streams of the
    copied members fresh; env state and timestep each member's own."""
    params, opt_states, obs_stats, kl_beta = copy_rows(
        (members.params, members.opt_states, members.obs_stats, members.kl_beta), src, do,
        offset, group)
    return members._replace(
        params=params, opt_states=opt_states, obs_stats=obs_stats, kl_beta=kl_beta,
        generator=resampled_streams(members.generator, do, generator, offset),
    )


def fires(settings: PBTSettings, updates_done: int) -> bool:
    """The JAX package's cadence: after window `interval`, `2·interval`, ..."""
    return updates_done > 0 and updates_done % settings.interval == 0


def make_pbt_step(settings: PBTSettings, pop_size: int, offset: int = 0, group: Any = None):
    """The exploit/explore transform over a PopulationState: identity off
    its cadence (no draw either), else the selection, the copies and the
    explore. `coins` ({hparam: [P] bool}) replaces the generator's draws.
    Over ranks, the state's members are rows `offset` on and `group` is the
    "pop" axis's."""

    def pbt_step(state: Any, coins: Optional[Dict[str, torch.Tensor]] = None) -> Any:
        if not fires(settings, int(state.updates_done)):
            return state
        src, do = truncation_selection(state.fitness, pop_size, settings.quantile)
        generator = state.pbt_generator
        if coins is None:
            coins = draw_coins(list(state.hparams), pop_size, generator)
        hparams = perturb_hparams(state.hparams, src, do, coins, settings.perturb_scale)
        # Exploited members inherit their source's fitness: ranked by their
        # own stale (pre-copy) score they would be exploited every round
        # until their first episode under the new params completes.
        fitness = torch.where(do, state.fitness.index_select(0, src), state.fitness)
        return state._replace(
            members=_copied_members(state.members, src, do, generator, offset, group),
            hparams=hparams,
            fitness=fitness,
            exploit_total=int(state.exploit_total) + int(do.sum()),
        )

    return pbt_step


# ---------------------------------------------------------------------------
# Integrity composition


def _sorted_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensor leaves of `tree` in `jax.tree.leaves`' order: dict keys
    sorted, records and sequences in field order."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _sorted_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for child in tree for leaf in _sorted_leaves(child)]
    return []


def member_fingerprints(params: Any) -> np.ndarray:
    """[P] uint32: each member's params folded through the sentinel's
    position-salted murmur fold (resilience/integrity.py), the JAX
    function's value for the same bytes. A member whose fingerprint moves
    without an update is the silent-corruption signal `quarantine_members`
    answers."""
    leaves = _sorted_leaves(params)
    pop_size = int(leaves[0].shape[0]) if leaves else 0
    return np.asarray([fingerprint_leaves([leaf[p] for leaf in leaves])
                       for p in range(pop_size)], dtype=np.uint32)


def quarantine_members(state: Any, corrupt: torch.Tensor, pop_size: int) -> Any:
    """Re-seed corrupt members from the fittest HEALTHY survivor instead of
    killing the run: params, optimizer states, observation statistics, β
    and hparams copy from the survivor exactly, the corrupt members' step
    streams are fresh, and their fitness is the survivor's."""
    corrupt = torch.as_tensor(corrupt, dtype=torch.bool).cpu()
    fit = ranked_fitness(state.fitness).cpu()
    healthy = torch.where(corrupt, torch.full_like(fit, -float("inf")), fit)
    survivor = int(torch.argmax(healthy))  # the first maximum, as jnp.argmax
    src = torch.where(corrupt, torch.full((pop_size,), survivor, dtype=torch.int64),
                      torch.arange(pop_size, dtype=torch.int64))
    return state._replace(
        members=_copied_members(state.members, src, corrupt, state.pbt_generator),
        hparams={name: torch.where(corrupt.to(v.device), v.index_select(0, src.to(v.device)), v)
                 for name, v in state.hparams.items()},
        fitness=torch.where(corrupt, state.fitness.index_select(0, src), state.fitness),
    )
