"""Small helpers over trees of tensors (NamedTuples, dicts, lists, tuples):
what `jax.tree.map` and friends give the JAX package."""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply `fn` to every tensor leaf of `tree` (and the matching leaves of
    `rest`); non-tensor leaves pass through from `tree`."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return tree


def tree_stack(trees: Sequence[Any]) -> Any:
    """Stack matching trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_merge_leading_dims(tree: Any, num_dims: int) -> Any:
    """Merge the first `num_dims` axes of every leaf into one."""
    return tree_map(lambda x: x.reshape((-1,) + x.shape[num_dims:]), tree)
