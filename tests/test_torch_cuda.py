"""Tests of the PyTorch port that need a CUDA card; each skips without one.

They import neither JAX nor the JAX package, so they also run on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(`--noconftest` skips tests/conftest.py, which sets JAX up.)
"""

import pytest
import torch

from stoix_tpu_torch.kernels import flash_attention as fa
from stoix_tpu_torch.kernels import linear_recurrence as lr
from stoix_tpu_torch.ops import multistep


def _require_cuda() -> torch.device:
    # Decided inside the test, never at import, so every worker collects the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _recurrence(t_len, batch, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.rand((t_len, batch), generator=gen, device=device)
    w = torch.where(torch.rand((t_len, batch), generator=gen, device=device) < 0.05, 0.0, w)
    d = torch.randn((t_len, batch), generator=gen, device=device)
    init = torch.randn((batch,), generator=gen, device=device)
    return w.to(dtype), d.to(dtype), init.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_len,batch", [(16, 1024), (17, 1000), (1, 1), (300, 129)])
def test_cuda_kernel_matches_plain_version_bitwise(dtype, t_len, batch):
    device = _require_cuda()
    w, d, init = _recurrence(t_len, batch, dtype, device)
    before = lr.KERNEL.launches
    got = lr.linear_recurrence_reverse(w, d, init)
    torch.cuda.synchronize()
    assert lr.KERNEL.launches == before + 1
    # Same arithmetic: one float32 FMA per step, each row rounded once.
    assert torch.equal(got, lr.plain_linear_recurrence_reverse(w, d, init))


@pytest.mark.cuda
def test_cuda_kernel_flattens_trailing_dims_and_casts_init():
    device = _require_cuda()
    w, d, init = _recurrence(9, 6 * 7, torch.float32, device, seed=1)
    w3, d3 = w.reshape(9, 6, 7), d.reshape(9, 6, 7)
    got = lr.linear_recurrence_reverse(w3, d3, init.reshape(6, 7).double())
    assert got.shape == (9, 6, 7)
    want = lr.plain_linear_recurrence_reverse(w, d, init)
    assert torch.equal(got.reshape(9, 42), want)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_cannot_take():
    device = _require_cuda()
    w, d, init = _recurrence(8, 16, torch.float32, device)
    with pytest.raises(ValueError, match="contiguous"):
        lr.KERNEL(w.t().contiguous().t(), d, init)
    with pytest.raises(ValueError, match="one CUDA device"):
        lr.KERNEL(w, d, init.cpu())
    with pytest.raises(TypeError):
        lr.KERNEL(w.half(), d.half(), init)


@pytest.mark.cuda
def test_gae_on_the_card_matches_the_cpu():
    device = _require_cuda()
    gen = torch.Generator().manual_seed(3)
    shape = (16, 256)
    r, v_tm1, v_t = (torch.randn(shape, generator=gen) for _ in range(3))
    done = torch.rand(shape, generator=gen) < 0.05
    trunc = ((torch.rand(shape, generator=gen) < 0.05) & ~done).float()
    discount = 0.99 * (1.0 - done.float())
    cpu = multistep.truncated_generalized_advantage_estimation(
        r, discount, 0.95, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc, impl="scan")
    before = lr.KERNEL.launches
    cuda = multistep.truncated_generalized_advantage_estimation(
        *(x.to(device) for x in (r, discount)), 0.95, v_tm1=v_tm1.to(device),
        v_t=v_t.to(device), truncation_t=trunc.to(device), impl="pallas")
    assert lr.KERNEL.launches == before + 1
    for a, b in zip(cpu, cuda):
        # Elementwise IEEE ops and the same FMA recurrence: bitwise.
        assert torch.equal(a, b.cpu())


def _qkv(shape, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(3))


# The kernels and the plain versions fold the same tiles but sum in another
# order: float32 is held at 1e-5 absolute, bfloat16 at 2e-2 (JAX's own bf16
# tolerance for this kernel, tests/test_pallas_attention.py).
def _atol(dtype):
    return 1e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,dtype", [
    ((64, 16, 4, 32), True, torch.float32),
    ((2, 100, 2, 32), False, torch.float32),
    ((2, 100, 2, 32), True, torch.float32),
    ((1, 128, 1, 64), True, torch.bfloat16),
    ((3, 4, 2, 16), True, torch.float32),
    ((1, 300, 1, 64), True, torch.float32),
    ((5, 1, 3, 16), False, torch.float32),
])
def test_flash_forward_kernel_matches_plain_version(shape, causal, dtype):
    device = _require_cuda()
    q, k, v = _qkv(shape, dtype, device)
    before = fa.FORWARD.launches
    got, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
    torch.cuda.synchronize()
    assert fa.FORWARD.launches == before + 1
    want, want_lse = fa.plain_flash_attention_forward(q, k, v, causal, need_lse=True)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=_atol(dtype))
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [
    ((64, 16, 4, 32), True), ((2, 100, 2, 32), False), ((2, 100, 2, 32), True),
])
def test_flash_backward_kernels_match_plain_version(shape, causal):
    device = _require_cuda()
    q, k, v = _qkv(shape, torch.float32, device, seed=1)
    dout = _qkv(shape, torch.float32, device, seed=2)[0]
    o, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
    before = (fa.BACKWARD_DQ.launches, fa.BACKWARD_DKDV.launches)
    got = fa.backward_kernels(q, k, v, o, lse, dout, causal)
    torch.cuda.synchronize()
    assert (fa.BACKWARD_DQ.launches, fa.BACKWARD_DKDV.launches) == (before[0] + 1, before[1] + 1)
    want = fa.plain_flash_attention_backward(q, k, v, o, lse, dout, causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_takes_strided_qkv_views_and_trains():
    device = _require_cuda()
    gen = torch.Generator(device=device).manual_seed(2)
    proj = torch.randn((32, 16, 3, 4, 32), generator=gen, device=device, requires_grad=True)
    q, k, v = proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]
    out = fa.flash_attention(q, k, v, causal=True)
    (out * out).sum().backward()
    ref = proj.detach().clone().requires_grad_(True)
    rq, rk, rv = (ref[:, :, i].contiguous() for i in range(3))
    want = fa.FlashAttention.apply(rq.cpu(), rk.cpu(), rv.cpu(), True)
    (want * want).sum().backward()
    torch.testing.assert_close(out.cpu(), want.detach(), rtol=0, atol=1e-5)
    torch.testing.assert_close(proj.grad.cpu(), ref.grad.cpu(), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_cannot_take():
    device = _require_cuda()
    q, k, v = _qkv((2, 16, 2, 32), torch.float32, device)
    with pytest.raises(ValueError, match="head dims"):
        fa.forward_kernel(*(x[..., :8] for x in (q, k, v)))
    with pytest.raises(TypeError):
        fa.forward_kernel(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.forward_kernel(q, k, v.cpu())
