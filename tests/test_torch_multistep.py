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


# ---------------------------------------------------------------- the other estimators
#
# The rest of the JAX module: the general off-policy return, Retrace,
# discounted returns, the importance-corrected TD errors and V-trace, each
# against `jax.jit` of its JAX counterpart (the 1-D V-trace and
# importance-corrected errors under `jax.vmap` over the batch axis), under
# the port's `scan` and `pallas` (on the CPU the kernel's plain version):
# bitwise, every fused multiply-add XLA contracts stated, and Retrace's exp
# of the log-ratios XLA's own float32 exp.


def _sequences(seed, batch=130, k=17):
    rng = np.random.default_rng(seed)
    normal = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    discount = (0.99 * (rng.uniform(size=(batch, k)) > 0.1)).astype(np.float32)
    return normal, rng, discount


def _count_generic_calls(monkeypatch):
    from stoix_tpu_torch.kernels import linear_recurrence

    calls = []
    original = linear_recurrence.linear_recurrence_reverse

    def counted(weight, delta, init):
        calls.append(tuple(weight.shape))
        return original(weight, delta, init)

    monkeypatch.setattr(linear_recurrence, "linear_recurrence_reverse", counted)
    return calls


@pytest.mark.parametrize("batch_major", [True, False])
@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_general_off_policy_returns_and_retrace_match_jax_bitwise(impl, batch_major,
                                                                  monkeypatch):
    normal, rng, discount = _sequences(11)
    q_tm1, q_t, v_t, r_t = normal(130, 17), normal(130, 16), normal(130, 17), normal(130, 17)
    c_t = rng.uniform(size=(130, 16)).astype(np.float32)
    log_rhos = normal(130, 16) * 0.8
    inputs = dict(general=(q_t, v_t, r_t, discount, c_t),
                  retrace=(q_tm1[:, :-1], q_t[:, :-1], v_t[:, 1:], r_t[:, :-1],
                           discount[:, :-1], log_rhos[:, :-1]))
    if not batch_major:
        inputs = {k: tuple(x.T.copy() for x in v) for k, v in inputs.items()}
    calls = _count_generic_calls(monkeypatch)
    want = jax.jit(functools.partial(jms.general_off_policy_returns_from_q_and_v,
                                     batch_major=batch_major, impl="scan"))(*inputs["general"])
    got = tms.general_off_policy_returns_from_q_and_v(*map(t, inputs["general"]),
                                                      batch_major=batch_major, impl=impl)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    want = jax.jit(functools.partial(jms.retrace_continuous, lambda_=0.95,
                                     batch_major=batch_major, impl="scan"))(*inputs["retrace"])
    got = tms.retrace_continuous(*map(t, inputs["retrace"]), 0.95, batch_major=batch_major,
                                 impl=impl)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert got.shape == inputs["retrace"][0].shape
    # One recurrence each, over K - 1 steps of the time-major view.
    assert calls == ([(16, 130), (15, 130)] if impl == "pallas" else [])


def test_retrace_target_carries_no_gradient_and_q_tm1_does():
    normal, _, discount = _sequences(12, batch=4, k=6)
    q_tm1 = t(normal(4, 5)).requires_grad_(True)
    q_t = t(normal(4, 4)).requires_grad_(True)
    errors = tms.retrace_continuous(q_tm1, q_t, t(normal(4, 5)), t(normal(4, 5)),
                                    t(discount[:, :5]), t(normal(4, 4)), 0.9)
    errors.sum().backward()
    assert q_t.grad is None
    assert np.array_equal(n(q_tm1.grad), -np.ones((4, 5), np.float32))


def test_xla_exp_is_jax_exp_bitwise():
    """XLA's float32 exp is not correctly rounded; the port states its
    algorithm, bitwise on 200 000 normals, through the underflow edge, the
    overflow edge and the specials."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        (rng.normal(size=200_000) * 3).astype(np.float32),
        np.linspace(-120.0, 100.0, 20_001, dtype=np.float32),
        np.array([0.0, -0.0, 1e-30, -87.33654, -87.33655, 88.72283, 88.72284, np.inf,
                  -np.inf], np.float32)])
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = n(tms.xla_exp_f32(t(x)))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(n(tms.xla_exp_f32(t(np.array([np.nan], np.float32))))).all()


@pytest.mark.parametrize("batch_major", [False, True])
@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_discounted_returns_match_jax_bitwise(impl, batch_major):
    normal, rng, _ = _sequences(13)
    r = normal(17, 40)
    discount = (0.9 * (rng.uniform(size=(17, 40)) > 0.1)).astype(np.float32)
    if batch_major:
        r, discount = r.T.copy(), discount.T.copy()
    for v_t in (0.5, normal(*r.shape)):
        want = jax.jit(lambda a, b, v: jms.discounted_returns(a, b, v, batch_major=batch_major,
                                                              impl="scan"))(r, discount, v_t)
        got = tms.discounted_returns(t(r), t(discount), v_t if isinstance(v_t, float) else t(v_t),
                                     batch_major=batch_major, impl=impl)
        np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("stop", [False, True])
@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_importance_corrected_td_errors_match_vmapped_jax_bitwise(impl, stop):
    normal, rng, _ = _sequences(14)
    r, values = normal(17, 40), normal(18, 40)
    discount = (0.9 * (rng.uniform(size=(17, 40)) > 0.1)).astype(np.float32)
    rho = np.exp(normal(17, 40) * 0.5).astype(np.float32)
    truncation = (rng.uniform(size=(17, 40)) < 0.1).astype(np.float32)
    for trunc in (truncation, None):
        fn = jax.vmap(lambda a, b, c, d, e: jms.importance_corrected_td_errors(
            a, b, c, 0.9, d, e, stop_target_gradients=stop, impl="scan"), in_axes=1, out_axes=1)
        want = jax.jit(fn)(r, discount, rho, values, truncation if trunc is None else trunc)
        if trunc is None:
            want = jax.jit(jax.vmap(lambda a, b, c, d: jms.importance_corrected_td_errors(
                a, b, c, 0.9, d, stop_target_gradients=stop, impl="scan"), in_axes=1,
                out_axes=1))(r, discount, rho, values)
        got = tms.importance_corrected_td_errors(
            t(r), t(discount), t(rho), 0.9, t(values), None if trunc is None else t(trunc),
            stop_target_gradients=stop, impl=impl)
        np.testing.assert_array_equal(n(got), np.asarray(want))
    # The 1-D form is the JAX function's own.
    want = jax.jit(lambda a, b, c, d: jms.importance_corrected_td_errors(
        a, b, c, 0.9, d, stop_target_gradients=stop))(r[:, 0], discount[:, 0], rho[:, 0],
                                                      values[:, 0])
    got = tms.importance_corrected_td_errors(t(r[:, 0]), t(discount[:, 0]), t(rho[:, 0]), 0.9,
                                             t(values[:, 0]), stop_target_gradients=stop,
                                             impl=impl)
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("stop", [True, False])
@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_vtrace_matches_vmapped_jax_bitwise(impl, stop):
    normal, rng, _ = _sequences(15)
    v_tm1, v_t, r = normal(17, 40), normal(17, 40), normal(17, 40)
    discount = (0.99 * (rng.uniform(size=(17, 40)) > 0.1)).astype(np.float32)
    rho = np.exp(normal(17, 40) * 0.7).astype(np.float32)
    want = jax.jit(jax.vmap(lambda a, b, c, d, e: jms.vtrace_td_error_and_advantage(
        a, b, c, d, e, 0.95, 1.2, 0.8, stop, impl="scan"), in_axes=1, out_axes=1))(
        v_tm1, v_t, r, discount, rho)
    got = tms.vtrace_td_error_and_advantage(t(v_tm1), t(v_t), t(r), t(discount), t(rho), 0.95,
                                            1.2, 0.8, stop, impl=impl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))


def test_port_exports_every_estimator_of_the_jax_module():
    import stoix_tpu.ops as jax_ops
    import stoix_tpu_torch.ops as port_ops

    names = [k for k in dir(jms) if not k.startswith("_") and callable(getattr(jms, k))
             and getattr(getattr(jms, k), "__module__", "") == jms.__name__]
    assert len(names) >= 16
    for name in names:
        assert callable(getattr(tms, name)), name
        if name in jax_ops.__all__:
            assert name in port_ops.__all__, name
