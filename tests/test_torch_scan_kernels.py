"""Kernel B1 of the PyTorch port — the reverse linear recurrence — against the
JAX package (stoix_tpu/ops/scan_kernels.py).

On CPU tensors the port's `pallas` impl is the kernel's plain version. Both
are held BITWISE in float32 against JAX's `_scan_reverse` and against the
Pallas kernel in interpret mode: XLA compiles `delta + weight * acc` into one
fused multiply-add, and the port rounds it the same way (a correctly rounded
FMA). bfloat16 inputs accumulate in float32, like the Pallas kernel, and are
held bitwise against it too. `assoc` reassociates, so it is held at 1e-5
relative in float32. The CUDA kernel itself is held against the plain
version on the card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.ops import scan_kernels as jsk
from stoix_tpu_torch.kernels import linear_recurrence as lr
from stoix_tpu_torch.ops import scan_kernels as tsk
from torch_parity import n, pallas_interpret, t

F32_RTOL = 1e-5  # assoc: float32 reassociation


def _recurrence(seed, t_len=17, batch=5, with_zeros=True):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 1.0, (t_len, batch)).astype(np.float32)
    if with_zeros:
        # Mid-trajectory terminations: discount 0 resets the recurrence.
        w[rng.integers(0, t_len, size=3), rng.integers(0, batch, size=3)] = 0.0
    d = rng.normal(size=(t_len, batch)).astype(np.float32)
    init = rng.normal(size=(batch,)).astype(np.float32)
    return w, d, init


@pytest.mark.parametrize("t_len,batch", [(17, 5), (16, 1024), (17, 130), (1, 3)])
def test_plain_and_pallas_dispatch_bitwise_match_jax_scan_f32(t_len, batch):
    w, d, init = _recurrence(t_len * 1000 + batch, t_len, batch)
    want = np.asarray(jsk._scan_reverse(jnp.asarray(w), jnp.asarray(d), jnp.asarray(init)))
    plain = lr.plain_linear_recurrence_reverse(t(w), t(d), t(init))
    dispatch = tsk.linear_recurrence_reverse(t(w), t(d), t(init), impl="pallas")
    scan = tsk.linear_recurrence_reverse(t(w), t(d), t(init), impl="scan")
    for got in (plain, dispatch, scan):
        np.testing.assert_array_equal(n(got), want)


@pytest.mark.parametrize("block_t", [4, 8, 64])
def test_plain_bitwise_matches_pallas_interpret_f32(block_t):
    # T=17 with block_t=4 crosses four block boundaries (the carry) and pads
    # time; 130 columns are a ragged batch past one 128-lane block.
    w, d, init = _recurrence(block_t, t_len=17, batch=130)
    want = pallas_interpret(w, d, init, block_t=block_t)
    got = lr.plain_linear_recurrence_reverse(t(w), t(d), t(init))
    np.testing.assert_array_equal(n(got), want)


def test_bf16_inputs_accumulate_in_f32_like_the_pallas_kernel():
    # Bitwise: both widen bf16 to float32, take one float32 FMA per step and
    # round each row once to bf16 (init is cast to the delta dtype first).
    w, d, init = _recurrence(21, t_len=17, batch=130)
    wb, db, ib = (jnp.asarray(x).astype(jnp.bfloat16) for x in (w, d, init))
    want = pallas_interpret(wb, db, ib, block_t=4)
    got = lr.plain_linear_recurrence_reverse(t(wb), t(db), t(ib))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(got), want)
    # `scan` in bf16 rounds every multiply and add to bf16, as XLA does for
    # the JAX loop.
    scan = tsk.linear_recurrence_reverse(t(wb), t(db), t(ib), impl="scan")
    jax_scan = np.asarray(jsk._scan_reverse(wb, db, ib).astype(jnp.float32))
    np.testing.assert_array_equal(n(scan), jax_scan)


def test_termination_reset_propagates_identically():
    w, d, init = _recurrence(9, t_len=10, batch=2, with_zeros=False)
    w[4] = 0.0
    want = pallas_interpret(w, d, init, block_t=4)
    outs = {impl: n(tsk.linear_recurrence_reverse(t(w), t(d), t(init), impl=impl))
            for impl in tsk.VALID_IMPLS}
    np.testing.assert_array_equal(outs["pallas"], want)
    np.testing.assert_array_equal(outs["scan"], want)
    np.testing.assert_allclose(outs["assoc"], want, rtol=F32_RTOL, atol=F32_RTOL)
    # Changing post-cut deltas must not leak into pre-cut outputs.
    d2 = d.copy()
    d2[7] += 100.0
    for impl in tsk.VALID_IMPLS:
        changed = n(tsk.linear_recurrence_reverse(t(w), t(d2), t(init), impl=impl))
        np.testing.assert_array_equal(changed[:5], outs[impl][:5])


@pytest.mark.parametrize("t_len", [1, 2, 7, 16, 17])
def test_assoc_matches_jax_assoc_f32(t_len):
    w, d, init = _recurrence(30 + t_len, t_len=t_len, batch=8)
    want = np.asarray(jsk._assoc_reverse(jnp.asarray(w), jnp.asarray(d), jnp.asarray(init)))
    got = n(tsk.linear_recurrence_reverse(t(w), t(d), t(init), impl="assoc"))
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_RTOL)


def test_fma_rounds_once_like_xla_on_a_double_rounding_case():
    # a*b = 2^-24 - 2^-71 and c = 1 + 2^-23: the float64 sum lands exactly
    # halfway between two float32 values while the exact sum lies below it.
    a = np.array([10610063 * 2.0**-24], np.float32)
    b = np.array([13264529 * 2.0**-47], np.float32)
    c = np.array([1 + 2.0**-23], np.float32)
    xla = np.asarray(jax.jit(lambda a, b, c: c + a * b)(a, b, c))
    naive = (c.astype(np.float64) + a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)
    assert naive[0] != xla[0]
    np.testing.assert_array_equal(n(lr.fma_f32(t(a), t(b), t(c))), xla)


def test_fma_matches_xla_on_random_inputs():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, 200_000).astype(np.float32)
    b = rng.normal(size=200_000).astype(np.float32)
    c = (rng.normal(size=200_000) * 100).astype(np.float32)
    xla = np.asarray(jax.jit(lambda a, b, c: c + a * b)(a, b, c))
    np.testing.assert_array_equal(n(lr.fma_f32(t(a), t(b), t(c))), xla)


def test_cpu_tensors_never_launch_the_kernel():
    w, d, init = _recurrence(3)
    lr.KERNEL.launches = 0
    tsk.linear_recurrence_reverse(t(w), t(d), t(init), impl="pallas")
    assert lr.KERNEL.launches == 0


def test_kernel_wrapper_validates_before_launching():
    w, d, init = _recurrence(4)
    with pytest.raises(ValueError, match="CUDA device"):
        lr.KERNEL(t(w), t(d), t(init))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lr.KERNEL(t(w, torch.float64), t(d, torch.float64), t(init))
    with pytest.raises(TypeError, match="one dtype"):
        lr.KERNEL(t(w, torch.bfloat16), t(d), t(init))
    assert lr.KERNEL.launches == 0


def test_default_impl_plumbing_and_validation():
    assert tsk.VALID_IMPLS == jsk.VALID_IMPLS
    assert tsk.resolve_impl(None) == "scan"
    with tsk.use_impl("assoc"):
        assert tsk.resolve_impl(None) == "assoc"
        assert tsk.resolve_impl("pallas") == "pallas"
    assert tsk.resolve_impl(None) == "scan"
    with pytest.raises(ValueError, match="unknown multistep impl"):
        tsk.resolve_impl("vectorized")

    class _Cfg:
        system = {"multistep_impl": "pallas"}

    try:
        assert tsk.configure_from_config(_Cfg()) == "pallas"
        assert tsk.get_default_impl() == "pallas"
    finally:
        tsk.set_default_impl("scan")
