"""Observation normalisation and the update guard of the PyTorch port against
the JAX package, on the same numpy inputs.

1. ops/running_statistics.py against stoix_tpu/ops/running_statistics.py:
   `update` (with its std clip), `normalize`, `denormalize`, `clip` and
   `normalize_observation`, float32 at 1e-6 relative to each statistic's
   largest entry (sums in another order, and a mean near 0 is a
   cancellation); the replicas' sums (`replica_axis`) against the JAX
   `update` under `jax.vmap(axis_name="batch")` with its psum, likewise.
2. resilience/guards.py against stoix_tpu/resilience/guards.py: the mode
   vocabulary, the step count's discovery, the guard's selection and
   metrics on a finite and a non-finite update (exact), and the host half:
   the counter and `DivergenceError` (exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.ops import running_statistics as jrs
from stoix_tpu.resilience import guards as jguards
from stoix_tpu.resilience.errors import DivergenceError as JaxDivergenceError
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.ops import running_statistics as rs
from stoix_tpu_torch.resilience import guards
from stoix_tpu_torch.resilience.errors import DivergenceError
from stoix_tpu_torch.utils.training import ClipAdam
from torch_parity import n, t

RTOL = 1e-6


def _batches(seed, shape, features):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape + (features,)) * rng.uniform(0.5, 3.0) + rng.normal()
             ).astype(np.float32) for _ in range(3)]


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()),
                               err_msg=err_msg)


def _assert_state(got, want):
    for name in ("count", "mean", "summed_variance", "std"):
        _close(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("std_bounds", [(1e-6, 1e6), (5e-4, 5e4), (0.9, 1.1)])
def test_update_matches_jax(std_bounds):
    lo, hi = std_bounds
    template = np.zeros((5,), np.float32)
    got, want = rs.init_state(t(template)), jrs.init_state(jnp.asarray(template))
    _assert_state(got, want)
    for batch in _batches(0, (4, 6), 5):  # [T, E, F] folded three times
        got = rs.update(got, t(batch), std_min_value=lo, std_max_value=hi)
        want = jrs.update(want, jnp.asarray(batch), std_min_value=lo, std_max_value=hi)
        _assert_state(got, want)


def test_update_of_a_tree_matches_jax():
    template = {"a": np.zeros((3,), np.float32), "b": np.zeros((2, 2), np.float32)}
    rng = np.random.default_rng(1)
    batch = {"a": rng.normal(size=(7, 3)).astype(np.float32),
             "b": rng.normal(size=(7, 2, 2)).astype(np.float32)}
    got = rs.update(rs.init_state({k: t(v) for k, v in template.items()}),
                    {k: t(v) for k, v in batch.items()})
    want = jrs.update(jrs.init_state(jax.tree.map(jnp.asarray, template)),
                      jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(n(got.count), np.asarray(want.count), rtol=0)
    for key in template:
        for name in ("mean", "summed_variance", "std"):
            _close(getattr(got, name)[key], getattr(want, name)[key], name)


def test_replica_sums_match_the_psum_over_batch():
    # U = 2 replicas, each folding its own [T, E, F] batch; the JAX package
    # psums over "batch", so every replica ends with the same statistics.
    update_batch, template = 2, np.zeros((4,), np.float32)
    want = jrs.init_state(jnp.asarray(template))
    want = jax.tree.map(lambda x: jnp.broadcast_to(x, (update_batch,) + x.shape), want)
    got = rs.init_state(t(template))
    fold = jax.vmap(lambda s, b: jrs.update(s, b, axis_names=("batch",), std_min_value=5e-4,
                                            std_max_value=5e4), axis_name="batch")
    for batch in _batches(2, (update_batch, 3, 8), 4):  # [U, T, E, F]
        want = fold(want, jnp.asarray(batch))
        # The port's [T, U·E, F] rollout, viewed [T, U, E, F].
        port = np.moveaxis(batch, 0, 1)
        got = rs.update(got, t(port), replica_axis=1, std_min_value=5e-4, std_max_value=5e4)
        for name in ("count", "mean", "summed_variance", "std"):
            replicas = np.asarray(getattr(want, name))
            np.testing.assert_array_equal(replicas[0], replicas[1])
            _close(getattr(got, name), replicas[0], name)


def test_normalize_denormalize_clip_match_jax():
    batches = _batches(3, (6,), 3)
    got = rs.update(rs.init_state(t(np.zeros(3, np.float32))), t(batches[0]))
    want = jrs.update(jrs.init_state(jnp.zeros(3, jnp.float32)), jnp.asarray(batches[0]))
    x = batches[1] * 4.0
    for max_abs in (None, 1.5):
        np.testing.assert_allclose(n(rs.normalize(t(x), got, max_abs)),
                                   np.asarray(jrs.normalize(jnp.asarray(x), want, max_abs)),
                                   rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(n(rs.denormalize(t(x), got)),
                               np.asarray(jrs.denormalize(jnp.asarray(x), want)), rtol=RTOL)
    np.testing.assert_array_equal(n(rs.clip(t(x), 2.0)), np.asarray(jrs.clip(jnp.asarray(x), 2.0)))
    from stoix_tpu.envs.types import Observation as JaxObservation

    mask, steps = np.ones((6, 2), np.float32), np.arange(6, dtype=np.int32)
    got_obs = rs.normalize_observation(Observation(t(x), t(mask), t(steps)), got)
    want_obs = jrs.normalize_observation(
        JaxObservation(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(steps)), want)
    np.testing.assert_allclose(n(got_obs.agent_view), np.asarray(want_obs.agent_view),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_array_equal(n(got_obs.step_count), np.asarray(want_obs.step_count))
    assert float(np.abs(n(got_obs.agent_view)).max()) <= 10.0


# ------------------------------------------------------------------ the guard


@pytest.mark.parametrize("raw,mode", [(None, "off"), ("off", "off"), ("skip", "skip"),
                                      ("HALT", "halt")])
def test_resolve_mode_matches_jax(raw, mode):
    cfg = jax_config.Config.from_dict({"system": {"update_guard": raw}})
    assert guards.resolve_mode(cfg) == jguards.resolve_mode(cfg) == mode


def test_resolve_mode_rejects_unknown_as_jax_does():
    cfg = jax_config.Config.from_dict({"system": {"update_guard": "explode"}})
    with pytest.raises(ValueError, match="update_guard"):
        guards.resolve_mode(cfg)
    with pytest.raises(ValueError, match="update_guard"):
        jguards.resolve_mode(cfg)


def test_find_step_count_reads_the_optimizer_state():
    optim = ClipAdam(1e-3, 0.5)
    params = {"w": torch.ones(3)}
    state = optim.update({"w": torch.ones(3)}, optim.init(params))[1]
    assert guards.find_step_count(({"x": 1}, [state])) == 1
    assert guards.find_step_count({"nothing": torch.zeros(1)}) is None


def _guard_inputs(seed, poison):
    rng = np.random.default_rng(seed)
    new = {"w": rng.normal(size=(3, 2)).astype(np.float32), "b": rng.normal(size=2).astype(
        np.float32)}
    old = {k: v + 1.0 for k, v in new.items()}
    grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in new.items()}
    loss = np.float32(np.nan if poison == "loss" else 0.7)
    if poison == "grads":
        grads["b"][0] = np.inf
    return new, old, grads, loss


@pytest.mark.parametrize("mode", ["skip", "halt"])
@pytest.mark.parametrize("poison", [None, "loss", "grads"])
def test_guard_update_matches_jax(mode, poison):
    new, old, grads, loss = _guard_inputs(5, poison)
    as_t = lambda tree: {k: t(v) for k, v in tree.items()}  # noqa: E731
    got, got_metrics = guards.guard_update(mode, new=as_t(new), old=as_t(old),
                                           loss=t(loss), grads=(as_t(grads),))
    want, want_metrics = jguards.guard_update(
        mode, new=jax.tree.map(jnp.asarray, new), old=jax.tree.map(jnp.asarray, old),
        loss=jnp.asarray(loss), grads=(jax.tree.map(jnp.asarray, grads),), axis_names=())
    for key in new:
        np.testing.assert_array_equal(n(got[key]), np.asarray(want[key]))
        np.testing.assert_array_equal(n(got[key]), (new if poison is None else old)[key])
    assert set(got_metrics) == set(want_metrics)
    for key, value in got_metrics.items():
        np.testing.assert_allclose(n(value), np.asarray(want_metrics[key]), rtol=1e-6)


def test_guard_off_adds_nothing():
    new, old, grads, loss = _guard_inputs(6, "loss")
    as_t = lambda tree: {k: t(v) for k, v in tree.items()}  # noqa: E731
    selected = as_t(new)
    got, metrics = guards.guard_update("off", new=selected, old=as_t(old), loss=t(loss),
                                       grads=(as_t(grads),))
    assert got is selected and metrics == {}


def test_publish_guard_metrics_matches_jax():
    flags = np.array([[0.0, 0.0], [1.0, 0.0]], np.float32)
    losses = np.array([[0.5, 0.4], [np.nan, 0.3]], np.float32)
    norms = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    metrics = {"skipped_updates": flags, "guard_loss": losses, "guard_grad_norm": norms}
    before = guards.skipped_counter().value()
    assert guards.publish_guard_metrics("skip", {k: t(v) for k, v in metrics.items()}, 7) == \
        jguards.publish_guard_metrics("skip", metrics, 7) == 1.0
    assert guards.skipped_counter().value() == before + 1.0
    assert guards.publish_guard_metrics("off", metrics, 7) == 0.0
    with pytest.raises(DivergenceError) as got:
        guards.publish_guard_metrics("halt", {k: t(v) for k, v in metrics.items()}, 9)
    with pytest.raises(JaxDivergenceError) as want:
        jguards.publish_guard_metrics("halt", metrics, 9)
    assert str(got.value) == str(want.value)
    assert (got.value.step, got.value.metric) == (9, "loss") and np.isnan(got.value.loss)
