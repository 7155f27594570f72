"""Batched MCTS (counterpart of stoix_tpu/search/mcts.py):

    muzero_policy(params, noise, root, recurrent_fn, num_simulations, ...)
    gumbel_muzero_policy(params, noise, root, recurrent_fn, num_simulations, ...)

The tree is a struct of tensors, one row a batch element: `visits`,
`values`, `rewards`, `discounts`, `parent` and `action_from_parent` [B, N],
`priors` and `children` [B, N, A], and the embeddings a tree of tensors
[B, N, ...], with N = num_simulations + 1 slots (slot 0 the root, slot s + 1
written by simulation s). Where the JAX package vmaps one element's search
over the batch, the B trees run here in lockstep, and each `while_loop`
becomes a fixed number of masked iterations with the same result:

  - at simulation s (from 0) no node is deeper than s, so the PUCT descent
    needs at most min(s + 1, max_depth) iterations and the backup one more;
    an element whose loop has ended keeps its state and writes nothing;
  - the bounds are host integers: the search reads nothing back from the
    device, so it launches the same ops whatever the data;
  - `recurrent_fn` is called once a simulation, on the B selected edges as
    one batch.

The corner cases are the JAX package's, slot for slot: a descent stopped by
`max_depth` on an expanded child writes slot s + 1 but does not link it (an
orphan with a parent, an action and 0 visits) and backs up the existing
child's value again; the root keeps `visits = 1` from the start and its
backup takes the `node == 0` branch; `value_min`/`value_max` skip unvisited
slots; index -1 (no parent, no child) is never gathered unmasked.

Randomness comes in as tensors, never from a key inside the search
(`SearchNoise`; `draw_noise` draws it from a generator): the root's
Dirichlet noise and the action draw's Gumbel noise of `muzero_policy`
(`jax.random.categorical` is argmax(logits + gumbel)), the root's Gumbel
noise of `gumbel_muzero_policy`, and `recurrent` [S, ...], whose s-th slice
`recurrent_fn` receives at simulation s (the sampled systems' per-node
normals, where the JAX package hands it the simulation's key).

Every float32 op rounds as `jax.jit` rounds the JAX package's on the CPU:
the multiply-adds XLA contracts are stated as fused ones
(`fused_multiply_add`), the softmaxes and logs take XLA's exp and log
(`xla_exp_f32`, `xla_log_f32`), and a division by a constant is XLA's
multiplication by the constant's float32 reciprocal. pb_c = pb_c_init +
log((N + pb_c_base + 1) / pb_c_base) and sqrt(N) depend only on a visit
count N <= num_simulations + 1, so each is a table built once a search and
gathered.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from stoix_tpu_torch.kernels.linear_recurrence import fma_f32
from stoix_tpu_torch.ops.multistep import xla_exp_f32, xla_log_f32
from stoix_tpu_torch.utils.tree import tree_map

NO_PARENT = -1
UNVISITED = -1
_TINY = float(np.finfo(np.float32).tiny)


class RootFnOutput(NamedTuple):
    prior_logits: torch.Tensor  # [B, A]
    value: torch.Tensor  # [B]
    embedding: Any  # a tree of tensors [B, ...]


class RecurrentFnOutput(NamedTuple):
    reward: torch.Tensor  # [B]
    discount: torch.Tensor  # [B]
    prior_logits: torch.Tensor  # [B, A]
    value: torch.Tensor  # [B]


# recurrent_fn(params, noise, action [B], embedding) -> (RecurrentFnOutput, new_embedding);
# `noise` is the simulation's slice of `SearchNoise.recurrent` (or None).
RecurrentFn = Callable[[Any, Optional[torch.Tensor], torch.Tensor, Any],
                       Tuple[RecurrentFnOutput, Any]]


class PolicyOutput(NamedTuple):
    action: torch.Tensor  # [B]
    action_weights: torch.Tensor  # [B, A]: the visit distribution (or completed-Q softmax)
    search_value: torch.Tensor  # [B]: the root value after the search


class SearchNoise(NamedTuple):
    dirichlet: Optional[torch.Tensor]  # [B, A] root noise of muzero_policy (None: no noise)
    gumbel: torch.Tensor  # [B, A] the action draw's (muzero) or the root's (gumbel) noise
    recurrent: Optional[torch.Tensor] = None  # [S, ...] recurrent_fn's noise a simulation


class Tree(NamedTuple):
    """The JAX package's fields. `values`, `rewards` and `discounts` are
    views of one [B, N, 3] tensor, so a gather reads all three at once; the
    node indices are int64, torch's index type."""

    visits: torch.Tensor  # [B, N] int32
    values: torch.Tensor  # [B, N] float32: the running mean of the backups
    priors: torch.Tensor  # [B, N, A]
    rewards: torch.Tensor  # [B, N]: the reward received entering the node
    discounts: torch.Tensor  # [B, N]
    parent: torch.Tensor  # [B, N] int64
    action_from_parent: torch.Tensor  # [B, N] int64
    children: torch.Tensor  # [B, N, A] int64: a node index or UNVISITED
    embeddings: Any  # a tree of tensors [B, N, ...]


def fused_multiply_add(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a . b + c rounded once: on CUDA tensors ONE `torch.addcmul(c, a, b)`,
    whose kernel (c + 1 . a . b) nvcc contracts into one fmaf
    (tests/test_torch_cuda.py holds it bitwise against `fma_f32`); on others
    `fma_f32`, exact in float64 (about 25 ops: a launch each on the card)."""
    if c.is_cuda:
        return torch.addcmul(c, a, b)
    return fma_f32(*torch.broadcast_tensors(a, b, c))


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softmax` over the last axis as XLA rounds it: XLA's exp of
    x - max(x), over its sum."""
    unnormalized = xla_exp_f32(logits - logits.amax(-1, keepdim=True), fused_multiply_add)
    return unnormalized / unnormalized.sum(-1, keepdim=True)


def gumbel(generator: Optional[torch.Generator], shape: Tuple[int, ...],
           device: Any) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u uniform on [tiny, 1), as
    `jax.random.gumbel` draws them."""
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=_TINY)
    return -torch.log(-torch.log(u))


def dirichlet(generator: Optional[torch.Generator], alpha: float, shape: Tuple[int, ...],
              device: Any) -> torch.Tensor:
    """Symmetric Dirichlet draws over the last axis: normalised standard
    gammas, drawn and summed in float64 (at alpha = 0.3 a float32 row of
    gammas can underflow to all zeros)."""
    alphas = torch.full(shape, float(alpha), dtype=torch.float64, device=device)
    gammas = torch._standard_gamma(alphas, generator=generator)
    return (gammas / gammas.sum(-1, keepdim=True)).to(torch.float32)


def draw_noise(generator: Optional[torch.Generator], batch: int, num_actions: int,
               dirichlet_fraction: float = 0.0, dirichlet_alpha: float = 0.3,
               device: Any = "cpu") -> SearchNoise:
    """A search's root noise from `generator`: the Dirichlet [B, A] when
    `dirichlet_fraction` > 0 (muzero_policy's), then the Gumbel [B, A]."""
    shape = (int(batch), int(num_actions))
    root = (dirichlet(generator, dirichlet_alpha, shape, device)
            if dirichlet_fraction > 0.0 else None)
    return SearchNoise(root, gumbel(generator, shape, device))


def _reciprocal(value: float) -> float:
    """The float32 reciprocal of a constant, which XLA multiplies by where
    the JAX package divides by the constant."""
    return float(np.float32(1.0) / np.float32(value))


def visit_tables(num_simulations: int, pb_c_init: float, pb_c_base: float,
                 device: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pb_c, sqrt) [num_simulations + 2]: for every visit count N a node
    can hold, pb_c_init + log((N + pb_c_base + 1) / pb_c_base) and sqrt(N)
    in float32, as `jax.jit` computes them (sqrt correctly rounded, through
    float64)."""
    counts = torch.arange(num_simulations + 2, dtype=torch.float32, device=device)
    ratio = ((counts + float(pb_c_base)) + 1.0) * _reciprocal(pb_c_base)
    pb_c = float(np.float32(pb_c_init)) + xla_log_f32(ratio, fused_multiply_add)
    return pb_c, counts.double().sqrt().float()


def _init_tree(root: RootFnOutput, num_nodes: int) -> Tuple[Tree, torch.Tensor]:
    """The B fresh trees and the [B, N, 3] tensor under their values,
    rewards and discounts."""
    batch, num_actions = root.prior_logits.shape
    device = root.prior_logits.device

    def slots(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((batch, num_nodes) + tuple(x.shape[1:]), dtype=x.dtype, device=device)
        out[:, 0] = x
        return out

    visits = torch.zeros((batch, num_nodes), dtype=torch.int32, device=device)
    visits[:, 0] = 1
    priors = torch.zeros((batch, num_nodes, num_actions), dtype=torch.float32, device=device)
    priors[:, 0] = softmax(root.prior_logits)
    stats = torch.zeros((batch, num_nodes, 3), dtype=torch.float32, device=device)
    stats[:, 0, 0] = root.value
    stats[..., 2] = 1.0
    nodes = partial(torch.full, fill_value=NO_PARENT, dtype=torch.long, device=device)
    tree = Tree(
        visits=visits,
        values=stats[..., 0],
        priors=priors,
        rewards=stats[..., 1],
        discounts=stats[..., 2],
        parent=nodes((batch, num_nodes)),
        action_from_parent=nodes((batch, num_nodes)),
        children=nodes((batch, num_nodes, num_actions)),
        embeddings=tree_map(slots, root.embedding),
    )
    return tree, stats


def _child_stats(visits: torch.Tensor, stats: torch.Tensor, children: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(visits, values, rewards, discounts) [B, A] of `children` [B, A] from
    the trees' `visits` [B, N] and their [B, N, 3] `stats`, 0 where a child
    is UNVISITED."""
    linked = children >= 0
    safe = children.clamp(min=0)
    child_visits = torch.where(linked, visits.gather(1, safe), 0)
    child_stats = torch.where(linked[..., None], stats.gather(
        1, safe[..., None].expand(safe.shape + (3,))), 0.0)
    return child_visits, child_stats[..., 0], child_stats[..., 1], child_stats[..., 2]


def _puct_scores(tree: Tree, stats: torch.Tensor, rows: torch.Tensor, node: torch.Tensor,
                 value_min: torch.Tensor, scale: torch.Tensor, pb_c: torch.Tensor,
                 sqrt: torch.Tensor) -> torch.Tensor:
    """PUCT over each element's `node`'s children [B, A], with min-max
    normalised Q (r + d v, one fused multiply-add; `scale` [B, 1] is
    max(value_max - value_min, 1e-8))."""
    child_visits, child_values, child_rewards, child_discounts = _child_stats(
        tree.visits, stats, tree.children[rows, node])
    q_raw = fused_multiply_add(child_discounts, child_values, child_rewards)
    q_norm = torch.where(child_visits > 0, (q_raw - value_min[:, None]) / scale, 0.0)
    parent_visits = tree.visits[rows, node].long()
    exploration = (pb_c[parent_visits][:, None] * tree.priors[rows, node]
                   * sqrt[parent_visits][:, None]) / (1.0 + child_visits.to(torch.float32))
    return q_norm + exploration


def search(params: Any, root: RootFnOutput, recurrent_fn: RecurrentFn, num_simulations: int,
           max_depth: int, pb_c_init: float, pb_c_base: float,
           recurrent_noise: Optional[torch.Tensor] = None) -> Tree:
    """The B trees after `num_simulations` simulations (the JAX package's
    `_search_one`, vmapped)."""
    num_simulations, max_depth = int(num_simulations), int(max_depth)
    tree, stats = _init_tree(root, num_simulations + 1)
    batch = root.value.shape[0]
    device = root.value.device
    rows = torch.arange(batch, device=device)
    pb_c, sqrt = visit_tables(num_simulations, pb_c_init, pb_c_base, device)
    inf = torch.tensor(math.inf, device=device)
    for sim in range(num_simulations):
        new_node = sim + 1
        visited = tree.visits > 0
        value_min = torch.where(visited, tree.values, inf).amin(1)
        value_max = torch.where(visited, tree.values, -inf).amax(1)
        scale = torch.clamp(value_max - value_min, min=1e-8)[:, None]

        # Descend by PUCT until an unexpanded edge or max depth; an element
        # stays at the PARENT of its selected edge once it stops.
        node = torch.zeros((batch,), dtype=torch.long, device=device)
        action = torch.zeros((batch,), dtype=torch.long, device=device)
        done = torch.zeros((batch,), dtype=torch.bool, device=device)
        for depth in range(min(sim + 1, max_depth)):
            scores = _puct_scores(tree, stats, rows, node, value_min, scale, pb_c, sqrt)
            selected = scores.argmax(-1)
            child = tree.children[rows, node, selected]
            stop = child == UNVISITED
            if depth + 1 >= max_depth:
                stop = torch.ones_like(stop)
            moving = ~done
            action = torch.where(moving, selected, action)
            node = torch.where(moving & ~stop, child, node)
            done = done | stop
        leaf_parent = node

        existing_child = tree.children[rows, leaf_parent, action]
        is_leaf = existing_child == UNVISITED
        parent_embedding = tree_map(lambda x: x[rows, leaf_parent], tree.embeddings)
        noise = None if recurrent_noise is None else recurrent_noise[sim]
        out, new_embedding = recurrent_fn(params, noise, action, parent_embedding)

        # Slot `new_node` is written whatever the edge, but LINKED only when
        # the edge was a true leaf.
        tree.priors[:, new_node] = softmax(out.prior_logits)
        tree.rewards[:, new_node] = out.reward
        tree.discounts[:, new_node] = out.discount
        tree.parent[:, new_node] = leaf_parent
        tree.action_from_parent[:, new_node] = action
        tree.children[rows, leaf_parent, action] = torch.where(is_leaf, new_node, existing_child)
        tree_map(lambda buf, e: buf.__setitem__((slice(None), new_node), e),
                 tree.embeddings, new_embedding)
        node = torch.where(is_leaf, new_node, existing_child)
        g = torch.where(is_leaf, out.value,
                        tree.values[rows, existing_child.clamp(min=0)])

        # Back up to the root, averaging values.
        for _ in range(min(sim + 1, max_depth) + 1):
            active = node != NO_PARENT
            safe = node.clamp(min=0)
            visits = tree.visits[rows, safe]
            values, rewards, discounts = stats[rows, safe].unbind(-1)
            new_value = fused_multiply_add(values, visits.to(torch.float32), g) / (
                visits + 1).to(torch.float32)
            new_value = torch.where((safe != 0) & (visits == 0), g, new_value)
            tree.visits[rows, safe] = visits + active.to(torch.int32)
            tree.values[rows, safe] = torch.where(active, new_value, values)
            g = torch.where(active, fused_multiply_add(discounts, g, rewards), g)
            node = torch.where(active, tree.parent[rows, safe], node)
    return tree


def _root_child_stats(tree: Tree) -> Tuple[torch.Tensor, ...]:
    stats = torch.stack((tree.values, tree.rewards, tree.discounts), -1)
    return _child_stats(tree.visits, stats, tree.children[:, 0])


def blend_root_action_noise(uniform: torch.Tensor, actions: torch.Tensor, fraction: float,
                            minimum: Any, maximum: Any) -> torch.Tensor:
    """Sampled-MuZero root exploration over a continuous sampled action set
    [B, K, A]: a = (1 - f) a + f u with u = lo + (hi - lo) x `uniform`
    (uniform on [0, 1), the shape of `actions`), per action dimension; the
    convex blend keeps the actions inside the action space."""
    if fraction <= 0.0:
        return actions
    lo = torch.as_tensor(minimum, dtype=actions.dtype, device=actions.device)
    hi = torch.as_tensor(maximum, dtype=actions.dtype, device=actions.device)
    shape = actions.shape
    noise = fused_multiply_add(*(torch.broadcast_to(x, shape) for x in (hi - lo, uniform, lo)))
    return fused_multiply_add(torch.full_like(actions, 1.0 - fraction), actions, fraction * noise)


def _root_with_noise(root: RootFnOutput, noise: Optional[torch.Tensor],
                     dirichlet_fraction: float) -> RootFnOutput:
    if dirichlet_fraction <= 0.0:
        return root
    probs = softmax(root.prior_logits)
    mixed = fused_multiply_add(torch.full_like(probs, 1.0 - dirichlet_fraction), probs,
                               dirichlet_fraction * noise)
    return root._replace(prior_logits=xla_log_f32(mixed + 1e-9, fused_multiply_add))


def muzero_policy(params: Any, noise: SearchNoise, root: RootFnOutput,
                  recurrent_fn: RecurrentFn, num_simulations: int,
                  max_depth: Optional[int] = None, dirichlet_fraction: float = 0.25,
                  dirichlet_alpha: float = 0.3, pb_c_init: float = 1.25,
                  pb_c_base: float = 19652.0, temperature: float = 1.0) -> PolicyOutput:
    """AlphaZero/MuZero search: PUCT with Dirichlet root noise
    (`noise.dirichlet`, drawn at `dirichlet_alpha` by `draw_noise`); the
    action is drawn from the visit distribution raised to 1 / temperature
    with `noise.gumbel`."""
    del dirichlet_alpha  # the noise comes drawn
    max_depth = int(max_depth or num_simulations)
    root = _root_with_noise(root, noise.dirichlet, dirichlet_fraction)
    tree = search(params, root, recurrent_fn, num_simulations, max_depth, pb_c_init, pb_c_base,
                  noise.recurrent)
    child_visits = _root_child_stats(tree)[0]
    visit_probs = child_visits.to(torch.float32) / torch.clamp(
        child_visits.sum(-1, keepdim=True), min=1).to(torch.float32)
    logits = xla_log_f32(visit_probs + 1e-9, fused_multiply_add) * _reciprocal(
        max(temperature, 1e-9))
    action = (noise.gumbel + logits).argmax(-1)
    return PolicyOutput(action=action, action_weights=visit_probs,
                        search_value=tree.values[:, 0])


def gumbel_muzero_policy(params: Any, noise: SearchNoise, root: RootFnOutput,
                         recurrent_fn: RecurrentFn, num_simulations: int,
                         max_depth: Optional[int] = None, max_num_considered_actions: int = 16,
                         qtransform_c_visit: float = 50.0, qtransform_c_scale: float = 0.1,
                         **_: Any) -> PolicyOutput:
    """Gumbel MuZero (Danihelka et al. 2022), simplified as in the JAX
    package: one PUCT-driven tree over the top-k Gumbel-perturbed root
    actions (no root noise), action argmax(gumbel + logits + sigma(Q)),
    weights softmax(logits + sigma(completed Q))."""
    max_depth = int(max_depth or num_simulations)
    num_actions = root.prior_logits.shape[-1]
    k = min(int(max_num_considered_actions), num_actions)
    perturbed = noise.gumbel + root.prior_logits
    threshold = perturbed.sort(-1).values[..., -k][..., None]
    restricted = torch.where(perturbed >= threshold, root.prior_logits, -math.inf)
    root = root._replace(prior_logits=restricted)
    tree = search(params, root, recurrent_fn, num_simulations, max_depth, 1.25, 19652.0,
                  noise.recurrent)
    root_values = tree.values[:, 0]
    child_visits, child_values, child_rewards, child_discounts = _root_child_stats(tree)
    q = fused_multiply_add(child_discounts, child_values, child_rewards)
    q_completed = torch.where(child_visits > 0, q, root_values[:, None])
    max_visits = child_visits.amax(-1, keepdim=True).to(torch.float32)
    # sigma(Q) = (c_visit + max visits) c_scale Q, its product fused into
    # the add of the logits it is added to.
    sigma_scale = torch.broadcast_to((qtransform_c_visit + max_visits) * qtransform_c_scale,
                                     q_completed.shape)
    action = fused_multiply_add(sigma_scale, q_completed, noise.gumbel + restricted).argmax(-1)
    weights = softmax(fused_multiply_add(sigma_scale, q_completed, restricted))
    return PolicyOutput(action=action, action_weights=weights, search_value=root_values)
