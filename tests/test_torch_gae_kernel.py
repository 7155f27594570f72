"""The GAE entry point of kernel B1 (kernels/linear_recurrence.py::truncated_gae)
against the JAX package's GAE (stoix_tpu/ops/multistep.py::
truncated_generalized_advantage_estimation), and the route the port's GAE
dispatch takes to it.

On CPU tensors the entry point is its plain version, `plain_truncated_gae`,
which computes in the kernel's order and roundings: one FMA for the delta's
`r + discount * v_t`, the weights' two multiplies, one FMA a step of the
recurrence, one add for the targets. It is held BITWISE against `jax.jit` of
the JAX GAE, where XLA contracts the same expressions the same way. The CUDA
kernel itself is held bitwise against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Under `multistep_impl: pallas`, float32 inputs with a scalar lambda take the
entry point; bfloat16 and a tensor lambda keep the composed path (the generic
recurrence between separate elementwise ops).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.ops import multistep as jms
from stoix_tpu_torch.kernels import linear_recurrence as lr
from stoix_tpu_torch.ops import multistep as tms
from torch_parity import n, pallas_interpret, t

T_LEN, BATCH = 17, 130  # a ragged time axis and a ragged batch past one 128-lane block
LAMBDA = 0.95


def _rollout(seed, t_len=T_LEN, batch=BATCH):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(t_len, batch)).astype(np.float32)
    done = rng.uniform(size=(t_len, batch)) < 0.08
    truncated = (rng.uniform(size=(t_len, batch)) < 0.05) & ~done
    discount = (0.99 * (1.0 - done)).astype(np.float32)
    v_tm1 = rng.normal(size=(t_len, batch)).astype(np.float32)
    v_t = np.concatenate([v_tm1[1:], rng.normal(size=(1, batch))]).astype(np.float32)
    ended = done | truncated
    v_t[ended] = rng.normal(size=int(ended.sum())).astype(np.float32)
    return r, discount, v_tm1, v_t, truncated.astype(np.float32)


def _jax_gae(*arrays, **kwargs):
    """`jax.jit` of the JAX GAE (as the JAX package always runs it), numpy out."""
    static = {k: v for k, v in kwargs.items() if not isinstance(v, np.ndarray)}
    arrays_kw = {k: jnp.asarray(v) for k, v in kwargs.items() if isinstance(v, np.ndarray)}
    fn = jax.jit(functools.partial(jms.truncated_generalized_advantage_estimation, **static))
    out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in arrays), **arrays_kw)
    return [np.asarray(x) for x in out]


@pytest.fixture
def routes(monkeypatch):
    """Records which entry of kernels/linear_recurrence.py the dispatch takes."""
    taken = []
    for name in ("truncated_gae", "linear_recurrence_reverse"):
        original = getattr(lr, name)

        def spy(*args, _name=name, _original=original, **kwargs):
            taken.append(_name)
            return _original(*args, **kwargs)

        monkeypatch.setattr(lr, name, spy)
    return taken


@pytest.mark.parametrize("truncation", [True, False])
def test_plain_gae_is_bitwise_the_jitted_jax_gae(truncation):
    r, discount, v_tm1, v_t, trunc = _rollout(0)
    kwargs = {"truncation_t": trunc} if truncation else {}
    want = _jax_gae(r, discount, LAMBDA, v_tm1=v_tm1, v_t=v_t, impl="scan", **kwargs)
    got = lr.plain_truncated_gae(t(r), t(discount), t(v_tm1), t(v_t),
                                 t(trunc) if truncation else None, LAMBDA)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(n(g), w)


@pytest.mark.parametrize("batch_major", [False, True])
def test_values_path_takes_the_entry_point_bitwise(routes, batch_major):
    rng = np.random.default_rng(1)
    r = rng.normal(size=(T_LEN, BATCH)).astype(np.float32)
    discount = (0.9 * (rng.uniform(size=(T_LEN, BATCH)) > 0.1)).astype(np.float32)
    values = rng.normal(size=(T_LEN + 1, BATCH)).astype(np.float32)
    if batch_major:
        r, discount, values = r.T.copy(), discount.T.copy(), values.T.copy()
    want = _jax_gae(r, discount, 0.9, values=values, batch_major=batch_major, impl="scan")
    got = tms.truncated_generalized_advantage_estimation(
        t(r), t(discount), 0.9, values=t(values), batch_major=batch_major, impl="pallas")
    assert routes == ["truncated_gae"]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(n(g), w)


@pytest.mark.parametrize("batch_major", [False, True])
def test_truncated_batch_major_path_takes_the_entry_point_bitwise(routes, batch_major):
    arrays = _rollout(2)
    if batch_major:
        arrays = tuple(a.T.copy() for a in arrays)
    r, discount, v_tm1, v_t, trunc = arrays
    want = _jax_gae(r, discount, LAMBDA, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc,
                    batch_major=batch_major, impl="scan")
    got = tms.truncated_generalized_advantage_estimation(
        t(r), t(discount), LAMBDA, v_tm1=t(v_tm1), v_t=t(v_t), truncation_t=t(trunc),
        batch_major=batch_major, impl="pallas")
    assert routes == ["truncated_gae"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), w)


@pytest.mark.parametrize("truncation_dtype", [torch.float32, torch.bool])
def test_pallas_dispatch_on_cpu_is_the_plain_entry_point(routes, truncation_dtype):
    r, discount, v_tm1, v_t, trunc = (t(a) for a in _rollout(3))
    got = tms.truncated_generalized_advantage_estimation(
        r, discount, LAMBDA, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc.to(truncation_dtype),
        impl="pallas")
    want = lr.plain_truncated_gae(r, discount, v_tm1, v_t, trunc, LAMBDA)
    assert routes == ["truncated_gae"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # And bitwise the composed path through the generic recurrence (`scan`).
    for g, w in zip(got, tms.truncated_generalized_advantage_estimation(
            r, discount, LAMBDA, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc, impl="scan")):
        assert torch.equal(g, w)


def test_tensor_lambda_keeps_the_composed_path_and_matches_jax(routes):
    r, discount, v_tm1, v_t, trunc = _rollout(4)
    lam = np.random.default_rng(5).uniform(0.8, 1.0, size=(T_LEN, BATCH)).astype(np.float32)
    want = _jax_gae(r, discount, lam, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc, impl="scan")
    got = tms.truncated_generalized_advantage_estimation(
        t(r), t(discount), t(lam), v_tm1=t(v_tm1), v_t=t(v_t), truncation_t=t(trunc),
        impl="pallas")
    assert routes == ["linear_recurrence_reverse"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), w)


def test_bf16_keeps_the_composed_path_and_matches_jax(routes):
    # bfloat16 under `pallas`: what the JAX package computes on its TPU, the
    # Pallas kernel (here in interpret mode) on the delta and weights that
    # `jax.jit` forms from the same bf16 inputs. The composed path's generic
    # recurrence accumulates in float32 like that kernel: bitwise.
    arrays = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)) for a in _rollout(6)]

    @jax.jit
    def producer(r, discount, v_tm1, v_t, trunc):
        lam = jnp.asarray(LAMBDA, r.dtype)
        return discount * lam * (1.0 - trunc), r + discount * v_t - v_tm1

    weight, delta = producer(*(jnp.asarray(a) for a in arrays))
    want = pallas_interpret(weight, delta, jnp.zeros_like(delta[0]), block_t=8)
    r, discount, v_tm1, v_t, trunc = (t(a) for a in arrays)
    advantages, targets = tms.truncated_generalized_advantage_estimation(
        r, discount, LAMBDA, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc, impl="pallas")
    assert routes == ["linear_recurrence_reverse"]
    assert advantages.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(advantages), want)
    assert torch.equal(targets, v_tm1 + advantages)


@pytest.mark.parametrize("impl", ["scan", "assoc"])
def test_other_impls_never_take_the_entry_point(routes, impl):
    r, discount, v_tm1, v_t, trunc = (t(a) for a in _rollout(7))
    tms.truncated_generalized_advantage_estimation(
        r, discount, LAMBDA, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc, impl=impl)
    assert "truncated_gae" not in routes


def test_gae_kernel_wrapper_validates_before_launching():
    r, discount, v_tm1, v_t, trunc = (t(a) for a in _rollout(8, t_len=4, batch=6))
    before = lr.GAE_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA device"):
        lr.GAE_KERNEL(r, discount, v_tm1, v_t, trunc, LAMBDA)
    with pytest.raises(TypeError, match="float32"):
        lr.GAE_KERNEL(r.double(), discount, v_tm1, v_t, trunc, LAMBDA)
    with pytest.raises(TypeError, match="float32"):
        lr.GAE_KERNEL(r, discount, v_tm1, v_t, trunc.bool(), LAMBDA)
    with pytest.raises(ValueError, match="shape"):
        lr.GAE_KERNEL(r, discount, v_tm1, v_t[:-1], trunc, LAMBDA)
    assert lr.GAE_KERNEL.launches == before
