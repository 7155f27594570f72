"""Tests of the PyTorch port that need a CUDA card; each skips without one.

They import neither JAX nor the JAX package, so they also run on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(`--noconftest` skips tests/conftest.py, which sets JAX up.)
"""

import pytest
import torch

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
