"""Gossip-averaged learner groups (counterpart of
stoix_tpu/parallel/gossip.py; "Gossip-based Actor-Learner Architectures",
arxiv 1906.04585).

The dense gradient all-reduce runs WITHIN a learner group only, and the
groups exchange parameters through a sparse, periodic gossip average
instead of a fleet-wide collective: a straggling group delays its
neighbours by one mixing edge, not the whole job.

The groups are ranks. A ("group", "data") mesh puts rank r in group
r // D: each rank runs ff_ppo's unchanged learner on its own group's state,
whose "data" collectives run over the group's data subgroup only
(systems/anakin.py::data_group). A mixing round is ONE contraction with a
[G, G] doubly stochastic matrix W,

    params'[g] = sum_h W[g, h] * params[h],

which each rank computes for its own group g: its float leaves, flattened
into one float32 bucket, are all-gathered over its subgroup of the "group"
axis (the G ranks that share its data coordinate) and contracted with row g
of W. Topologies:

  ring         W = (1-w)·I + (w/2)·(R + Rᵀ)      (R = one-step rotation;
                                                   G == 2 collapses to the
                                                   single shared edge)
  all_pairs    W = (1-w)·I + (w/G)·1              (dense average, the
                                                   synchronous limit)
  random_peer  W = (1-w)·I + w·R^s,  s in [1, G)  (one random directed edge
                                                   a group a round)

All three are doubly stochastic, so the group mean of the parameters is
invariant under mixing.

random_peer's shift: the JAX package draws it in-graph from
`jax.random.fold_in(PRNGKey(seed), round)`, a stream torch cannot
reproduce. The port's `mixing_matrix` takes the round's shift as an
argument, and `random_peer_shift(seed, round, G)` derives it on the host
from (seed, round) with a `torch.Generator`, identically on every rank
(ROADMAP, ground rules, beside C21).

Bit-identity contract: with ONE group the step is the identity, returned
un-dispatched (`step=None`), because even W = [[1.0]] would evaluate
`(1-w)·p + w·p`, which is not bitwise `p`. A one-group run is therefore the
lockstep path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from stoix_tpu_torch.kernels.linear_recurrence import fma_f32
from stoix_tpu_torch.utils.tree import tree_leaves, tree_map

# The learner-group mesh axis.
GROUP_AXIS = "group"

TOPOLOGIES = ("ring", "all_pairs", "random_peer")

MeshLike = Union[DeviceMesh, Dict[str, int]]


class GossipError(ValueError):
    """Invalid arch.gossip block or grouped-mesh configuration."""


class GossipSettings(NamedTuple):
    """Resolved `arch.gossip` config block (defaults applied)."""

    enabled: bool
    interval: int  # gossip every N eval windows
    topology: str  # ring | all_pairs | random_peer
    mixing_weight: float  # w in (0, 1]: how far toward the neighbours to move
    average_opt_states: bool  # mix optimizer state alongside params
    seed: int  # random_peer edge stream seed


class GossipPlan(NamedTuple):
    """What the Anakin runner needs to dispatch gossip: the step (None when
    the mix is the identity: one group), the window cadence, and the facts
    the run reports."""

    step: Optional[Callable[[Any, int], Any]]
    interval: int
    topology: str
    num_groups: int
    mixing_weight: float
    average_opt_states: bool


def settings_from_config(config: Any) -> GossipSettings:
    block = dict((config.get("arch") or {}).get("gossip") or {})
    settings = GossipSettings(
        enabled=bool(block.get("enabled", False)),
        interval=int(block.get("interval", 1)),
        topology=str(block.get("topology", "ring")),
        mixing_weight=float(block.get("mixing_weight", 0.5)),
        average_opt_states=bool(block.get("average_opt_states", False)),
        seed=int(block.get("seed", 0)),
    )
    if settings.interval < 1:
        raise GossipError(f"arch.gossip.interval must be >= 1 (got {settings.interval})")
    if settings.topology not in TOPOLOGIES:
        raise GossipError(
            f"arch.gossip.topology must be one of {TOPOLOGIES} (got '{settings.topology}')")
    if not (0.0 < settings.mixing_weight <= 1.0):
        raise GossipError(
            f"arch.gossip.mixing_weight must be in (0, 1] (got {settings.mixing_weight})")
    return settings


def mesh_axes(mesh: MeshLike) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh, or the dict itself."""
    if isinstance(mesh, DeviceMesh):
        return {name: int(mesh.size(i)) for i, name in enumerate(mesh.mesh_dim_names)}
    return dict(mesh)


def validate_grouped_config(config: Any, mesh: MeshLike) -> GossipSettings:
    """Cross-checks for a grouped-learner run on `mesh` (a DeviceMesh, or
    its {axis: size} when one process runs one group); returns the resolved
    settings. Subsystems that assume replicated learner state cannot run
    over groups that own different params between rounds."""
    axes = mesh_axes(mesh)
    if GROUP_AXIS not in axes:
        raise GossipError(
            f"grouped learner training needs a '{GROUP_AXIS}' mesh axis; arch.mesh declares "
            f"{axes} — compose with arch=gossip (or add group to arch.mesh)")
    settings = settings_from_config(config)
    num_groups = int(axes[GROUP_AXIS])
    if num_groups > 1 and not settings.enabled:
        raise GossipError(
            f"arch.mesh declares {num_groups} learner groups but arch.gossip.enabled=false: "
            "the groups would train forever WITHOUT exchanging parameters (set "
            "arch.gossip.enabled=true, or use group: 1)")
    if bool(((config.get("arch") or {}).get("integrity") or {}).get("enabled", False)):
        raise GossipError(
            "arch.integrity.enabled=true is not supported under grouped training: the "
            "sentinel's replica fingerprints assume replicated state, but each group owns "
            "DIFFERENT params between gossip rounds")
    if bool(config.arch.get("fused_eval", False)):
        raise GossipError(
            "arch.fused_eval is not supported under grouped training (the evaluator serves "
            "group 0's params, selected outside the learn step)")
    return settings


def random_peer_shift(seed: int, round_idx: int, num_groups: int) -> int:
    """random_peer's shift for one round, s in [1, G): drawn on the host from
    a torch.Generator seeded by (seed, round), the same on every rank."""
    state = np.random.SeedSequence([int(seed), int(round_idx)]).generate_state(1, np.uint64)[0]
    generator = torch.Generator().manual_seed(int(state >> np.uint64(1)))
    return int(torch.randint(1, num_groups, (), generator=generator))


def mixing_matrix(settings: GossipSettings, num_groups: int,
                  shift: Optional[int] = None) -> torch.Tensor:
    """The [G, G] doubly stochastic float32 mixing matrix of one round.
    random_peer takes the round's `shift` in [1, G) (`random_peer_shift`)."""
    w = settings.mixing_weight
    eye = torch.eye(num_groups, dtype=torch.float32)
    if settings.topology == "all_pairs":
        dense = torch.full((num_groups, num_groups), 1.0 / num_groups, dtype=torch.float32)
        return (1.0 - w) * eye + w * dense
    if settings.topology == "ring":
        right = torch.roll(eye, 1, dims=1)
        if num_groups == 2:
            # Left and right neighbour are the SAME group: one edge, full w.
            return (1.0 - w) * eye + w * right
        left = torch.roll(eye, -1, dims=1)
        return (1.0 - w) * eye + (w / 2.0) * (right + left)
    if shift is None or not 1 <= int(shift) < num_groups:
        raise GossipError(f"random_peer needs the round's shift in [1, {num_groups}) "
                          f"(got {shift})")
    return (1.0 - w) * eye + w * torch.roll(eye, int(shift), dims=1)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once: one `torch.addcmul` on CUDA (nvcc contracts
    its kernel into an fmaf), `fma_f32` elsewhere."""
    if c.is_cuda:
        return torch.addcmul(c, a, b)
    return fma_f32(*torch.broadcast_tensors(a, b, c))


def mix_row(weights: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """sum_h weights[h] * stacked[h] in float32 as XLA's CPU dot contracts
    it: w_0 x_0 rounded, then one fused multiply-add a term, h in order
    (bitwise `jax.jit` of the JAX package's `_mix_leaf`)."""
    acc = weights[0] * stacked[0]
    for h in range(1, stacked.shape[0]):
        acc = _fma(weights[h], stacked[h], acc)
    return acc


def _mix_leaf(matrix: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Contract the leading [G] axis of a stacked leaf with the mixing
    matrix, in float32. Integer leaves pass through: they are identical
    across groups by construction and a float average would corrupt them."""
    if not leaf.is_floating_point():
        return leaf
    stacked = leaf.to(torch.float32)
    weights = matrix.to(stacked.device)
    return torch.stack([mix_row(weights[g], stacked) for g in range(leaf.shape[0])]
                       ).to(leaf.dtype)


def _gather(bucket: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """[G, N]: every rank's bucket over `group`, in its rank order. NCCL
    gathers on the card; any other backend (gloo) on host copies."""
    on_host = dist.get_backend(group) != "nccl"
    local = bucket.cpu() if on_host else bucket.contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.stack(parts).to(bucket.device)


def mix_tree(tree: Any, matrix: torch.Tensor, group: dist.ProcessGroup) -> Any:
    """This rank's group's row of one mixing round over `tree`: its float
    leaves in one float32 bucket, all-gathered over `group` (the "group"
    axis's ranks that share this rank's data coordinate) and contracted with
    row g of `matrix`, g this rank's index in `group`; other leaves, and
    entries that are not tensors (a host step count), as they are."""
    leaves = [leaf for leaf in tree_leaves(tree) if leaf.is_floating_point()]
    if not leaves:
        return tree
    bucket = torch.cat([leaf.detach().reshape(-1).to(torch.float32) for leaf in leaves])
    row = matrix[dist.get_rank(group)].to(bucket.device)
    mixed = mix_row(row, _gather(bucket, group))
    parts: List[torch.Tensor] = list(mixed.split([leaf.numel() for leaf in leaves]))
    it = iter(parts)
    return tree_map(lambda leaf: (next(it).view(leaf.shape).to(leaf.dtype)
                                  if leaf.is_floating_point() else leaf), tree)


def build_gossip_plan(config: Any, mesh: Optional[MeshLike]) -> Optional[GossipPlan]:
    """The gossip step of a grouped learner state on `mesh` (a DeviceMesh,
    or its {axis: size} for one group in one process).

    The state must expose `.params` and `.opt_states` (`PPOLearnerState`
    does), each rank holding its own group's. Returns None when gossip is
    disabled, and a plan with `step=None` for ONE group (the identity, see
    the module docstring). `step(state, round_idx)` runs one round: every
    rank of the job must call it."""
    settings = settings_from_config(config)
    if not settings.enabled:
        return None
    axes = mesh_axes(mesh or {})
    if GROUP_AXIS not in axes:
        raise GossipError(
            f"arch.gossip.enabled=true needs a '{GROUP_AXIS}' mesh axis; arch.mesh declares "
            f"{axes}")
    num_groups = int(axes[GROUP_AXIS])
    facts = dict(interval=settings.interval, topology=settings.topology,
                 num_groups=num_groups, mixing_weight=settings.mixing_weight,
                 average_opt_states=settings.average_opt_states)
    if num_groups == 1:
        return GossipPlan(step=None, **facts)
    if not isinstance(mesh, DeviceMesh):
        raise GossipError(f"{num_groups} learner groups need a process group: one rank a "
                          "group and data shard (torchrun or arch.distributed.*)")
    group = mesh.get_group(GROUP_AXIS)

    def step(state: Any, round_idx: int) -> Any:
        shift = (random_peer_shift(settings.seed, round_idx, num_groups)
                 if settings.topology == "random_peer" else None)
        matrix = mixing_matrix(settings, num_groups, shift)
        if settings.average_opt_states:
            params, opt_states = mix_tree((state.params, state.opt_states), matrix, group)
            return state._replace(params=params, opt_states=opt_states)
        return state._replace(params=mix_tree(state.params, matrix, group))

    return GossipPlan(step=step, **facts)
