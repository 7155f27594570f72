"""Divergence guard for the gradient step (counterpart of
stoix_tpu/resilience/guards.py).

One non-finite gradient poisons the params for good: NaN flows through Adam
into every weight. The guard wraps the PPO minibatch update with a finiteness
test of the LOSS and the GLOBAL GRAD-NORM, selected by `system.update_guard`:

  off    (default) adds no op and no metric
  skip   `torch.where` selects the pre-update params and optimizer state on
         the device when the signal is non-finite (no host branch, no sync);
         the optimizer's step count still advances (a host int here, taken
         from the new state, as the JAX package's `_advance_counts` takes
         it); a `skipped_updates` flag rides the train metrics and the host
         sums it into the `stoix_tpu_learner_skipped_updates_total` counter
  halt   the same selection, and the host raises DivergenceError naming the
         step, the loss and the offending metric once the window's metrics
         are materialised (`publish_guard_metrics`)

Update-batch replicas and data ranks: the caller passes the loss and the
gradients already averaged over the replicas and then over the data ranks
(one all-reduce, systems/anakin.py::data_mean), so every replica of every
rank makes the same decision, as the JAX package's pmean over ("batch",
"data") makes it. The flag is emitted once per minibatch update, not once per
replica, so the host sum counts each skipped update once; the window's
metrics are averaged over the ranks, so the host half decides alike on each.

Fault injection (`nan_loss:N`, resilience/faultinject.py) lives inside the
guard, as in the JAX package: when the optimizer's step count (the host int
`count` found in the pre-update `opt_state`) is N, the loss and every float
leaf of the update are poisoned with NaN. Under `off` that poisons the
params for good (the failure the guard exists for); under `skip` and `halt`
the guard catches it. A caller runs the guard whenever `active(mode)`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from stoix_tpu_torch.observability import get_registry
from stoix_tpu_torch.resilience import faultinject
from stoix_tpu_torch.resilience.errors import DivergenceError
from stoix_tpu_torch.utils.tree import tree_map

VALID_MODES = ("off", "skip", "halt")
SKIPPED_COUNTER = "stoix_tpu_learner_skipped_updates_total"


def resolve_mode(config: Any) -> str:
    """Validated `system.update_guard` ('off' when unset)."""
    raw = config.system.get("update_guard", "off")
    mode = "off" if raw in (None, False, "~") else str(raw).lower()
    if mode not in VALID_MODES:
        raise ValueError(f"system.update_guard={raw!r} is not one of {list(VALID_MODES)}")
    return mode


def find_step_count(tree: Any) -> Any:
    """First value bound to a NamedTuple field named 'count' (ClipAdamState
    keeps the optimizer step there). Depth-first through NamedTuples, tuples,
    lists and dicts; None when absent."""
    if hasattr(tree, "_fields"):
        for field in tree._fields:
            value = getattr(tree, field)
            if field == "count" and not hasattr(value, "_fields"):
                return value
            found = find_step_count(value)
            if found is not None:
                return found
    elif isinstance(tree, (tuple, list)):
        for value in tree:
            found = find_step_count(value)
            if found is not None:
                return found
    elif isinstance(tree, dict):
        for value in tree.values():
            found = find_step_count(value)
            if found is not None:
                return found
    return None


def global_norm(grads: Sequence[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """optax.global_norm over several gradient dicts: sqrt of the sum of
    every leaf's sum of squares."""
    return torch.sqrt(sum(torch.sum(g * g) for tree in grads for g in tree.values()))


def active(mode: str) -> bool:
    """Whether a learner must run `guard_update`: a guard mode, or an armed
    `nan_loss` fault (which poisons the update under every mode)."""
    return mode != "off" or faultinject.poison_step() is not None


def guard_update(
    mode: str, *, new: Any, old: Any, loss: Optional[torch.Tensor],
    grads: Sequence[Dict[str, torch.Tensor]], opt_state: Any = None,
) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """The guard around one minibatch update. `new` and `old` are matching
    (params, opt_states) trees after and before the update; `loss` the
    minibatch loss (the replicas' mean); `grads` the gradient dicts the
    update applied; `opt_state` the pre-update optimizer state, where an
    armed `nan_loss` reads the step count. Returns (the selected tree, the
    guard's metrics): under 'off' `new` as it is (poisoned when the fault
    fires) and no metrics. Tensor leaves are selected on the device; a leaf
    that is not a tensor (the optimizer's host step count) is taken from
    `new`."""
    poison_at = faultinject.poison_step()
    if mode == "off" and poison_at is None:
        return new, {}
    if poison_at is not None:
        count = find_step_count(opt_state)
        if count is None or int(count) == poison_at:  # no counter found: poison always
            # NaN * 0 is NaN: every float leaf of the update becomes a real
            # poisoned update, not just a poisoned detection signal.
            new = tree_map(lambda x: x + float("nan") if x.is_floating_point() else x, new)
            loss = None if loss is None else loss + float("nan")
    if mode == "off":
        return new, {}
    loss = loss.to(torch.float32)
    grad_norm = global_norm(grads).to(torch.float32)
    bad = ~(torch.isfinite(loss) & torch.isfinite(grad_norm))
    selected = tree_map(lambda n, o: torch.where(bad, o, n), new, old)
    metrics = {
        "skipped_updates": bad.to(torch.float32),
        "guard_loss": loss,
        "guard_grad_norm": grad_norm,
    }
    return selected, metrics


def skipped_counter():
    return get_registry().counter(
        SKIPPED_COUNTER,
        "Gradient updates no-op'ed by the divergence guard (update_guard=skip/halt)",
    )


def publish_guard_metrics(mode: str, train_metrics: Any, step: int) -> float:
    """The guard's host half, once a window's train metrics are on the host:
    folds the window's skipped-update flags into the registry counter and,
    under 'halt', raises DivergenceError at the first flagged entry. Returns
    the number of skips seen."""
    if mode == "off":
        return 0.0
    flags = train_metrics.get("skipped_updates") if hasattr(train_metrics, "get") else None
    if flags is None:
        return 0.0
    flags = _host(flags)
    skipped = float(flags.sum())
    if skipped:
        skipped_counter().inc(skipped)
        if mode == "halt":
            losses = _host(train_metrics["guard_loss"])
            norms = _host(train_metrics["guard_grad_norm"])
            idx = int(np.argmax(flags > 0.0))
            metric = "loss" if not np.isfinite(losses[idx]) else "grad_norm"
            raise DivergenceError(step, losses[idx], norms[idx], metric)
    return skipped


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64).reshape(-1)
