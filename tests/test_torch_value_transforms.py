"""The port's value transforms (ops/value_transforms.py), n-step bootstrapped
returns (ops/multistep.py::n_step_bootstrapped_returns) and the windowed
fold behind them (ops/scan_kernels.py::affine_window_fold) against
`jax.jit` of the JAX package's functions, as its learners run them, on the
CPU.

- `signed_hyperbolic` and `signed_parabolic`: bitwise (the port states
  XLA's fused multiply-adds, its reciprocal of 2 eps and a correctly rounded
  square root).
- `n_step_bootstrapped_returns` under `scan` with lambda 1.0 (as R2D2 runs
  it): bitwise, at n = 1, 3, 5 and n past the sequence, batch- and
  time-major. With any other lambda (0.7, a tensor) XLA's choice of which
  product of the mix to fuse differs between the unrolled passes: 1e-6
  relative.
- Under `assoc` and `pallas` (the fold, which reassociates by design):
  1e-6 relative to the output's largest entry. No kernel launches on either.
- `transformed_n_step_q_learning_td`, `twohot` and `muzero_pair`: 1e-6
  relative (the support is a linspace, which jnp and torch round apart by an
  ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.ops import multistep as jmultistep
from stoix_tpu.ops import scan_kernels as jscan
from stoix_tpu.ops import value_transforms as jvt
from stoix_tpu_torch.kernels import linear_recurrence
from stoix_tpu_torch.ops import multistep, scan_kernels, value_transforms as vt
from torch_parity import n, t


def _values(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(size=4000) * 60, rng.uniform(-3, 3, 4000),
                           [0.0, -0.0, 1e-30, -1e-7, 3e4, -3e4]]).astype(np.float32)


@pytest.mark.parametrize("name", ["signed_hyperbolic", "signed_parabolic"])
def test_value_transforms_are_bitwise_jax_jit(name):
    x = _values(0)
    want = np.asarray(jax.jit(getattr(jvt, name))(x))
    np.testing.assert_array_equal(n(getattr(vt, name)(t(x))), want)
    # The pair inverts itself to float32 round-off.
    pair = vt.SIGNED_HYPERBOLIC_PAIR
    back = n(pair.apply_inv(pair.apply(t(x))))
    np.testing.assert_allclose(back, x, rtol=2e-3, atol=1e-3)


def _nstep_inputs(seed, batch=6, t_len=9):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, t_len)).astype(np.float32),
            (0.99 * (rng.random((batch, t_len)) > 0.2)).astype(np.float32),
            (rng.normal(size=(batch, t_len)) * 5).astype(np.float32),
            rng.random((batch, t_len)).astype(np.float32))


def _jax_nstep(r, g, v, lam, n_step, impl, batch_major=True):
    fn = lambda *a: jmultistep.n_step_bootstrapped_returns(  # noqa: E731
        *a[:3], n=n_step, lambda_t=a[3], batch_major=batch_major, impl=impl)
    return np.asarray(jax.jit(fn)(r, g, v, lam))


@pytest.mark.parametrize("n_step", [1, 3, 5, 12])
@pytest.mark.parametrize("batch_major", [True, False])
def test_n_step_scan_with_lambda_one_is_bitwise_jax_jit(n_step, batch_major):
    r, g, v, _ = _nstep_inputs(n_step)
    if not batch_major:
        r, g, v = r.T.copy(), g.T.copy(), v.T.copy()
    want = _jax_nstep(r, g, v, 1.0, n_step, "scan", batch_major)
    got = multistep.n_step_bootstrapped_returns(t(r), t(g), t(v), n=n_step, lambda_t=1.0,
                                                batch_major=batch_major, impl="scan")
    np.testing.assert_array_equal(n(got), want)


@pytest.mark.parametrize("n_step", [1, 3, 5, 12])
@pytest.mark.parametrize("tensor_lambda", [False, True])
def test_n_step_scan_with_another_lambda_matches_jax_jit(n_step, tensor_lambda):
    r, g, v, lam = _nstep_inputs(10 + n_step)
    lam_arg = lam if tensor_lambda else 0.7
    want = _jax_nstep(r, g, v, lam_arg, n_step, "scan")
    got = multistep.n_step_bootstrapped_returns(
        t(r), t(g), t(v), n=n_step, lambda_t=t(lam) if tensor_lambda else 0.7, impl="scan")
    np.testing.assert_allclose(n(got), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("impl", ["assoc", "pallas"])
@pytest.mark.parametrize("n_step", [1, 3, 5, 12])
@pytest.mark.parametrize("tensor_lambda", [False, True])
def test_n_step_fold_matches_jax_jit_and_launches_nothing(impl, n_step, tensor_lambda):
    r, g, v, lam = _nstep_inputs(20 + n_step)
    lam_arg = lam if tensor_lambda else 1.0
    want = _jax_nstep(r, g, v, lam_arg, n_step, impl)
    before = {c.name: c.launches for c in linear_recurrence.COUNTERS}
    got = multistep.n_step_bootstrapped_returns(
        t(r), t(g), t(v), n=n_step, lambda_t=t(lam) if tensor_lambda else 1.0, impl=impl)
    assert {c.name: c.launches for c in linear_recurrence.COUNTERS} == before
    np.testing.assert_allclose(n(got), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    scan = multistep.n_step_bootstrapped_returns(
        t(r), t(g), t(v), n=n_step, lambda_t=t(lam) if tensor_lambda else 1.0, impl="scan")
    np.testing.assert_allclose(n(got), n(scan), rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n_step,length", [(1, 5), (2, 5), (3, 8), (7, 8), (8, 8), (11, 4)])
def test_affine_window_fold_matches_jax(n_step, length):
    rng = np.random.default_rng(n_step)
    extra = max(n_step - 1, 0)
    weight = rng.uniform(0.5, 1.0, (length + extra, 3)).astype(np.float32)
    delta = rng.normal(size=(length + extra, 3)).astype(np.float32)
    boot = rng.normal(size=(length, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda w, d, b: jscan.affine_window_fold(w, d, b, n_step))(
        weight, delta, boot))
    got = scan_kernels.affine_window_fold(t(weight), t(delta), t(boot), n_step)
    np.testing.assert_allclose(n(got), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    for k in (0, 1, 3):
        for g_, w_ in zip(scan_kernels._shift_maps(t(weight), t(delta), k),
                          jscan._shift_maps(jnp.asarray(weight), jnp.asarray(delta), k)):
            np.testing.assert_array_equal(n(g_), np.asarray(w_))


def test_transformed_n_step_td_matches_jax():
    rng = np.random.default_rng(3)
    t_len, actions = 10, 4
    q_tm1 = rng.normal(size=(t_len + 1, actions)).astype(np.float32) * 3
    target_q = rng.normal(size=(t_len + 1, actions)).astype(np.float32) * 3
    a_tm1 = rng.integers(0, actions, t_len + 1).astype(np.int32)
    a_t = rng.integers(0, actions, t_len + 1).astype(np.int32)
    r = rng.normal(size=t_len).astype(np.float32)
    d = (0.97 * (rng.random(t_len) > 0.1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: jvt.transformed_n_step_q_learning_td(*a, n=3))(
        q_tm1, a_tm1, target_q, a_t, r, d))
    got = vt.transformed_n_step_q_learning_td(t(q_tm1), t(a_tm1), t(target_q), t(a_t), t(r),
                                              t(d), n=3)
    np.testing.assert_allclose(n(got), want, rtol=1e-6, atol=1e-6)


def test_twohot_and_muzero_pair_match_jax():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(size=200) * 200, [-400.0, 400.0, 0.0]]).astype(np.float32)
    atoms = np.linspace(-10, 10, 21).astype(np.float32)
    np.testing.assert_allclose(n(vt.twohot(t(x / 20), t(atoms))),
                               np.asarray(jvt.twohot(jnp.asarray(x / 20), jnp.asarray(atoms))),
                               rtol=1e-6, atol=1e-6)
    jpair, tpair = jvt.muzero_pair(num_atoms=61, vmin=-30.0, vmax=30.0), vt.muzero_pair(
        num_atoms=61, vmin=-30.0, vmax=30.0)
    assert tpair.num_atoms == jpair.num_atoms == 61
    probs = np.asarray(jax.jit(jpair.apply)(x))
    np.testing.assert_allclose(n(tpair.apply(t(x))), probs, rtol=1e-5, atol=1e-6)
    # The read: the support's expectation 1e-6 relative, then the inverse
    # transform (bitwise JAX's, above) of it.
    logits = rng.normal(size=(7, 61)).astype(np.float32)
    support = jnp.linspace(-30.0, 30.0, 61)
    want = np.asarray(jax.jit(lambda z: jnp.sum(jax.nn.softmax(z, -1) * support, -1))(logits))
    got = torch.sum(torch.softmax(t(logits), -1) * torch.linspace(-30.0, 30.0, 61), -1)
    np.testing.assert_allclose(n(got), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(n(tpair.apply_inv(t(logits))), n(vt.signed_parabolic(got)))
    # A scalar survives the round trip through its two-hot code.
    inside = x[np.abs(vt.signed_hyperbolic(t(x)).numpy()) < 30]
    np.testing.assert_allclose(n(tpair.apply_inv(torch.log(tpair.apply(t(inside)) + 1e-30))),
                               inside, rtol=1e-3, atol=1e-3)
