"""Truncation-aware GAE of the PyTorch port against the JAX package
(stoix_tpu/ops/multistep.py::truncated_generalized_advantage_estimation).

Both sides get the same numpy inputs; the JAX side runs its reference `scan`
impl under `jax.jit` (as the JAX package always runs GAE) and the port runs
each of its three impls. In float32 `scan` and `pallas` are bitwise: the
recurrence is one FMA per step (test_torch_scan_kernels.py) and the delta
states the FMA that XLA contracts `r + discount * v` into. Standardised
advantages are held at 1e-6 absolute, because their mean and std reduce in
another order than XLA's; `assoc` is held at 2e-6, float reassociation.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stoix_tpu.ops import multistep as jms
from stoix_tpu_torch.ops import multistep as tms
from torch_parity import n, t

ATOL = {"scan": 0.0, "pallas": 0.0, "assoc": 2e-6}
STANDARDIZED_ATOL = 1e-6


def _rollout(seed, t_len=16, batch=32):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(t_len, batch)).astype(np.float32)
    done = rng.uniform(size=(t_len, batch)) < 0.08
    truncated = (rng.uniform(size=(t_len, batch)) < 0.05) & ~done
    discount = (0.99 * (1.0 - done)).astype(np.float32)
    v_tm1 = rng.normal(size=(t_len, batch)).astype(np.float32)
    # Bootstrap values of the TRUE next observations: equal to the next step's
    # v_tm1 except where an episode ended and the env auto-reset.
    v_t = np.concatenate([v_tm1[1:], rng.normal(size=(1, batch))]).astype(np.float32)
    ended = done | truncated
    v_t[ended] = rng.normal(size=int(ended.sum())).astype(np.float32)
    return r, discount, v_tm1, v_t, truncated.astype(np.float32)


def _both(impl, *arrays, **kwargs):
    arrays_kw = {k: v for k, v in kwargs.items() if isinstance(v, np.ndarray)}
    static_kw = {k: v for k, v in kwargs.items() if not isinstance(v, np.ndarray)}
    reference = jax.jit(functools.partial(
        jms.truncated_generalized_advantage_estimation, **static_kw, impl="scan"))
    want = reference(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in arrays),
        **{k: jnp.asarray(v) for k, v in arrays_kw.items()},
    )
    got = tms.truncated_generalized_advantage_estimation(
        *(t(a) if isinstance(a, np.ndarray) else a for a in arrays),
        **{k: t(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()},
        impl=impl,
    )
    return [np.asarray(x) for x in want], [n(x) for x in got]


@pytest.mark.parametrize("impl", ["scan", "assoc", "pallas"])
@pytest.mark.parametrize("standardize", [False, True])
def test_gae_with_truncation_matches_jax(impl, standardize):
    r, discount, v_tm1, v_t, trunc = _rollout(0)
    want, got = _both(
        impl, r, discount, 0.95, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc,
        standardize_advantages=standardize,
    )
    advantages_atol = max(ATOL[impl], STANDARDIZED_ATOL) if standardize else ATOL[impl]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=advantages_atol)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ATOL[impl])


@pytest.mark.parametrize("impl", ["scan", "assoc", "pallas"])
def test_gae_values_path_and_batch_major_match_jax(impl):
    rng = np.random.default_rng(1)
    r = rng.normal(size=(8, 12)).astype(np.float32)
    discount = (0.9 * (rng.uniform(size=(8, 12)) > 0.1)).astype(np.float32)
    values = rng.normal(size=(9, 12)).astype(np.float32)
    want, got = _both(impl, r, discount, 0.9, values=values)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL[impl])
    # Batch-major inputs come back batch-major.
    want, got = _both(
        impl, r.T.copy(), discount.T.copy(), 0.9, values=values.T.copy(), batch_major=True
    )
    for w, g in zip(want, got):
        assert g.shape == (12, 8)
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL[impl])


def test_truncation_cuts_accumulation_but_bootstraps_delta():
    # One env, a truncation at t=2: advantages before it must not see the
    # rewards after it, and the truncated step still bootstraps through v_t.
    r = np.array([[1.0], [1.0], [1.0], [5.0]], np.float32)
    discount = np.full((4, 1), 0.9, np.float32)
    v_tm1 = np.zeros((4, 1), np.float32)
    v_t = np.array([[0.0], [0.0], [2.0], [0.0]], np.float32)
    trunc = np.array([[0.0], [0.0], [1.0], [0.0]], np.float32)
    for impl in ("scan", "assoc", "pallas"):
        want, got = _both(impl, r, discount, 1.0, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        # delta_2 = 1 + 0.9 * 2 = 2.8; no flow from t=3 (reward 5) into t<=2.
        np.testing.assert_allclose(got[0][2, 0], 2.8, atol=1e-6)
        np.testing.assert_allclose(got[0][1, 0], 1.0 + 0.9 * 2.8, atol=1e-6)


def test_termination_zeroes_the_bootstrap():
    # A termination (discount 0) drops v_t entirely; a truncation keeps it.
    r = np.ones((2, 2), np.float32)
    discount = np.array([[0.0, 0.99], [0.99, 0.99]], np.float32)
    v_tm1 = np.zeros((2, 2), np.float32)
    v_t = np.full((2, 2), 10.0, np.float32)
    trunc = np.array([[0.0, 1.0], [0.0, 0.0]], np.float32)
    want, got = _both("pallas", r, discount, 0.95, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc)
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    np.testing.assert_allclose(got[0][0], [1.0, 1.0 + 0.99 * 10.0], atol=1e-5)


def test_pallas_equals_scan_bitwise_in_float32():
    r, discount, v_tm1, v_t, trunc = _rollout(3, t_len=16, batch=256)
    outs = {
        impl: [n(x) for x in tms.truncated_generalized_advantage_estimation(
            t(r), t(discount), 0.95, v_tm1=t(v_tm1), v_t=t(v_t), truncation_t=t(trunc),
            standardize_advantages=True, impl=impl)]
        for impl in ("scan", "pallas")
    }
    for a, b in zip(outs["scan"], outs["pallas"]):
        np.testing.assert_array_equal(a, b)


def test_shape_mismatch_raises():
    r, discount, v_tm1, v_t, trunc = _rollout(4)
    with pytest.raises(ValueError):
        tms.truncated_generalized_advantage_estimation(
            t(r), t(discount), 0.95, v_tm1=t(v_tm1), v_t=t(v_t[:-1])
        )
