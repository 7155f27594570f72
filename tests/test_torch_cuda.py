"""Tests of the PyTorch port that need a CUDA card; each skips without one.

They import neither JAX nor the JAX package, so they also run on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(`--noconftest` skips tests/conftest.py, which sets JAX up.)
"""

import pytest
import torch
import torch.distributed as dist

from stoix_tpu_torch import parallel
from stoix_tpu_torch.kernels import flash_attention as fa
from stoix_tpu_torch.kernels import flash_attention_chunk as fac
from stoix_tpu_torch.kernels import flash_attention_wide as wide
from stoix_tpu_torch.kernels import linear_recurrence as lr
from stoix_tpu_torch.networks.attention import TransformerTorso
from stoix_tpu_torch.ops import best_attention, full_attention, multistep
from stoix_tpu_torch.ops.ring_attention import ring_attention
from stoix_tpu_torch.utils.config import Config


# The attention references on the host run in float64 (rounded to float32 to
# compare): the host of an H100 machine has computed a float32 plain
# attention 8.6e-5 off in one process of eight (ROADMAP.md C11);
# `test_host_float32_route_on_card_drawn_inputs_matches_float64` watches for it.
def _torso_reference(torso, x):
    """The torso's output and parameter gradients of (out ** 2).sum() in
    float64 on the host, rounded to float32."""
    import copy
    ref = copy.deepcopy(torso).double()
    out = ref(x.double())
    (out ** 2).sum().backward()
    return out.detach().float(), [p.grad.float() for p in ref.parameters()]


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


# The kernel cuts time into one 16-row stage over 8 warps (T <= 16) or 64-row
# stages over 4 warps, rows interleaved over the warps, and columns into
# blocks of 32: the shapes below cross each of those edges.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_len,batch", [
    (16, 1024), (17, 1000), (1, 1), (300, 129),
    *((t_len, 1000) for t_len in (1, 15, 33, 63, 64, 65, 129)),
    (128, 4096),  # a long rollout: two stages
    (5, 31), (70, 33),  # one ragged column block; two stages over two column blocks
])
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
    before = (lr.KERNEL.launches, lr.GAE_KERNEL.launches)
    cuda = multistep.truncated_generalized_advantage_estimation(
        *(x.to(device) for x in (r, discount)), 0.95, v_tm1=v_tm1.to(device),
        v_t=v_t.to(device), truncation_t=trunc.to(device), impl="pallas")
    # float32 with a scalar lambda: the GAE entry point, one launch, and the
    # generic recurrence not at all.
    assert (lr.KERNEL.launches, lr.GAE_KERNEL.launches) == (before[0], before[1] + 1)
    for a, b in zip(cpu, cuda):
        # Elementwise IEEE ops and the same FMA recurrence: bitwise.
        assert torch.equal(a, b.cpu())


def _gae_inputs(t_len, batch, device, seed, truncation=True):
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (t_len, batch)
    r, v_tm1, v_t = (torch.randn(shape, generator=gen, device=device) for _ in range(3))
    done = torch.rand(shape, generator=gen, device=device) < 0.05
    trunc = ((torch.rand(shape, generator=gen, device=device) < 0.03) & ~done).float()
    discount = 0.99 * (1.0 - done.float())
    return r, discount, v_tm1, v_t, trunc if truncation else None


@pytest.mark.cuda
@pytest.mark.parametrize("t_len,batch,truncation", [
    (16, 1024, True), (16, 1024, False), (17, 1000, True), (128, 4096, True), (65, 33, True),
])
def test_gae_kernel_matches_plain_version_bitwise(t_len, batch, truncation):
    device = _require_cuda()
    args = _gae_inputs(t_len, batch, device, seed=t_len + batch, truncation=truncation)
    before = lr.GAE_KERNEL.launches
    got = lr.truncated_gae(*args, 0.95)
    torch.cuda.synchronize()
    assert lr.GAE_KERNEL.launches == before + 1
    want = lr.plain_truncated_gae(*args, 0.95)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (t_len, batch)
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_gae_kernel_rejects_what_it_cannot_take():
    device = _require_cuda()
    r, discount, v_tm1, v_t, trunc = _gae_inputs(8, 16, device, seed=0)
    before = lr.GAE_KERNEL.launches
    with pytest.raises(ValueError, match="contiguous"):
        lr.GAE_KERNEL(r.t().contiguous().t(), discount, v_tm1, v_t, trunc, 0.95)
    with pytest.raises(ValueError, match="one CUDA device"):
        lr.GAE_KERNEL(r, discount, v_tm1.cpu(), v_t, trunc, 0.95)
    with pytest.raises(TypeError, match="float32"):
        lr.GAE_KERNEL(r, discount, v_tm1, v_t, trunc.bool(), 0.95)
    with pytest.raises(TypeError, match="float32"):
        lr.GAE_KERNEL(*(x.bfloat16() for x in (r, discount, v_tm1, v_t, trunc)), 0.95)
    with pytest.raises(ValueError, match="shape"):
        lr.GAE_KERNEL(r, discount, v_tm1, v_t, trunc[:, :8], 0.95)
    assert lr.GAE_KERNEL.launches == before


def _qkv(shape, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(3))


# The kernels and the plain versions fold the same tiles but sum in another
# order: float32 is held at 1e-5 absolute, bfloat16 at 2e-2 (JAX's own bf16
# tolerance for this kernel, tests/test_pallas_attention.py), float16 at 2e-3
# (two float16 ulps in [1, 2)).
def _atol(dtype):
    return {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,dtype", [
    ((64, 16, 4, 32), True, torch.float32),
    ((2, 100, 2, 32), False, torch.float32),
    ((2, 100, 2, 32), True, torch.float32),
    ((1, 128, 1, 64), True, torch.bfloat16),
    ((3, 4, 2, 16), True, torch.float32),
    ((1, 300, 1, 64), True, torch.float32),
    ((5, 1, 3, 16), False, torch.float32),
    ((64, 512, 4, 32), True, torch.float32),  # eight 64-row query tiles, the ring's window
    ((3, 65, 2, 32), True, torch.float32),  # one full 64-key tile and one key
    ((3, 16, 5, 32), True, torch.float32),  # 15 pairs: the last block holds 3 of 4
    # Head dims 8 and 128 and float16 (C6): short and long sequences.
    ((64, 16, 4, 8), True, torch.float32),
    ((2, 100, 2, 8), True, torch.bfloat16),
    ((16, 16, 2, 128), True, torch.float32),
    ((2, 300, 2, 128), True, torch.float32),
    ((64, 16, 4, 32), True, torch.float16),
    ((2, 100, 2, 128), False, torch.float16),
    # Head dim 256 (C8): short and long sequences, in all three dtypes.
    ((64, 16, 4, 256), True, torch.float32),
    # Pairs shorter than a thread's output rows (D / 16): R is raised to them.
    ((16, 4, 2, 128), True, torch.float32),
    ((8, 3, 2, 256), True, torch.float32),
    ((8, 7, 2, 256), False, torch.bfloat16),
    ((2, 300, 2, 256), True, torch.float32),
    ((2, 300, 2, 256), True, torch.bfloat16),
    ((2, 100, 2, 256), False, torch.float16),
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
@pytest.mark.parametrize("shape,dtype", [
    ((4096, 16, 4, 32), torch.float32),
    ((64, 512, 4, 32), torch.float32),
    ((2, 300, 2, 64), torch.bfloat16),
    ((2, 300, 2, 128), torch.float16),
    ((2, 300, 2, 256), torch.float32),
])
def test_flash_forward_kernel_is_deterministic(shape, dtype):
    # No atomics, every sum in a fixed order: two calls agree bit for bit.
    q, k, v = _qkv(shape, dtype, _require_cuda(), seed=3)
    first = fa.forward_kernel(q, k, v, True, need_lse=True)
    second = fa.forward_kernel(q, k, v, True, need_lse=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,dtype", [
    ((64, 16, 4, 32), True, torch.float32),
    ((2, 100, 2, 32), False, torch.float32),
    ((2, 100, 2, 32), True, torch.float32),
    ((2, 300, 2, 64), True, torch.float32),  # five 64-key tiles: dQ partials summed
    ((5, 1, 3, 16), False, torch.float32),
    ((1, 128, 1, 64), True, torch.bfloat16),
    # Head dims 8 and 128 and float16 (C6): one key tile and several.
    ((64, 16, 4, 8), True, torch.float32),
    ((2, 100, 2, 8), False, torch.float32),
    ((16, 16, 2, 128), True, torch.float32),
    ((2, 200, 2, 128), True, torch.float32),
    ((64, 16, 4, 32), True, torch.float16),
    ((1, 128, 1, 128), True, torch.float16),
    # Head dim 256 (C8): 32-row tiles; one key tile (S <= 32) and several.
    ((64, 16, 4, 256), True, torch.float32),
    ((2, 33, 2, 256), True, torch.float32),
    ((2, 300, 2, 256), True, torch.float32),
    ((2, 100, 2, 256), False, torch.bfloat16),
    ((16, 16, 2, 256), True, torch.float16),
])
def test_flash_backward_kernels_match_plain_version(shape, causal, dtype):
    device = _require_cuda()
    q, k, v = _qkv(shape, dtype, device, seed=1)
    dout = _qkv(shape, dtype, device, seed=2)[0]
    o, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
    before = fa.BACKWARD.launches
    got = fa.backward_kernel(q, k, v, o, lse, dout, causal)
    torch.cuda.synchronize()
    assert fa.BACKWARD.launches == before + 1
    want = fa.plain_flash_attention_backward(q, k, v, o, lse, dout, causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == q.shape and g.is_contiguous()
        # 16-bit types also relative: a gradient above 2 is a bf16 ulp of 1.6e-2
        # (a float16 ulp of 2e-3) or more apart wherever the two fp32 sums
        # round to neighbouring values.
        rtol = 0 if dtype == torch.float32 else _atol(dtype)
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=_atol(dtype))
    # Deterministic: no atomics, partials summed in a fixed order.
    for g, again in zip(got, fa.backward_kernel(q, k, v, o, lse, dout, causal)):
        assert torch.equal(g, again)


@pytest.mark.cuda
def test_flash_attention_takes_strided_qkv_views_and_trains():
    device = _require_cuda()
    gen = torch.Generator(device=device).manual_seed(2)
    proj = torch.randn((32, 16, 3, 4, 32), generator=gen, device=device, requires_grad=True)
    q, k, v = proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]
    out = fa.flash_attention(q, k, v, causal=True)
    (out * out).sum().backward()
    ref = proj.detach().cpu().double().requires_grad_(True)
    want = full_attention(ref[:, :, 0], ref[:, :, 1], ref[:, :, 2], causal=True)
    (want * want).sum().backward()
    torch.testing.assert_close(out.cpu(), want.detach().float(), rtol=0, atol=1e-5)
    torch.testing.assert_close(proj.grad.cpu(), ref.grad.float(), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_host_float32_route_on_card_drawn_inputs_matches_float64():
    # The strided-view test's inputs, drawn on the card, through the port's
    # float32 route on CPU tensors (the plain versions, forward and backward)
    # against float64: 1e-5 and 1e-4, as above. On the host of an H100
    # machine this route once missed by 1.1e-4 (ROADMAP.md C11); this test
    # keeps that fault visible.
    device = _require_cuda()
    gen = torch.Generator(device=device).manual_seed(2)
    proj = torch.randn((32, 16, 3, 4, 32), generator=gen, device=device).cpu()
    leaf = proj.clone().requires_grad_(True)
    got = fa.FlashAttention.apply(*(leaf[:, :, i].contiguous() for i in range(3)), True)
    (got * got).sum().backward()
    ref = proj.double().requires_grad_(True)
    want = full_attention(ref[:, :, 0], ref[:, :, 1], ref[:, :, 2], causal=True)
    (want * want).sum().backward()
    torch.testing.assert_close(got.detach(), want.detach().float(), rtol=0, atol=1e-5)
    torch.testing.assert_close(leaf.grad, ref.grad.float(), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_cannot_take():
    device = _require_cuda()
    q, k, v = _qkv((2, 16, 2, 32), torch.float32, device)
    with pytest.raises(ValueError, match="head dims"):  # the dispatch pads 24 to 32
        fa.forward_kernel(*(x[..., :24] for x in (q, k, v)))
    with pytest.raises(TypeError):
        fa.forward_kernel(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.forward_kernel(q, k, v.cpu())


@pytest.mark.cuda
def test_flash_forward_on_strided_views_over_200_seeds():
    # The strided-view test above, swept over 200 seeds: the kernel's output
    # and gradients against the plain version on the card and on the CPU.
    device = _require_cuda()
    failures, worst = [], 0.0
    for seed in range(200):
        gen = torch.Generator(device=device).manual_seed(seed)
        proj = torch.randn((32, 16, 3, 4, 32), generator=gen, device=device, requires_grad=True)
        out = fa.flash_attention(proj[:, :, 0], proj[:, :, 1], proj[:, :, 2], causal=True)
        (out * out).sum().backward()
        views = [proj.detach()[:, :, i] for i in range(3)]
        on_card = fa.plain_flash_attention_forward(*views, True)[0]
        ref = proj.detach().cpu().requires_grad_(True)
        on_cpu = fa.FlashAttention.apply(*(ref[:, :, i].contiguous() for i in range(3)), True)
        (on_cpu * on_cpu).sum().backward()
        errors = ((out - on_card).abs().max().item(), (out.cpu() - on_cpu).abs().max().item())
        grad_error = (proj.grad.cpu() - ref.grad).abs().max().item()
        worst = max(worst, *errors)
        if max(errors) > 1e-5 or grad_error > 1e-4:
            share = ((out.cpu() - on_cpu).abs() > 1e-5).float().mean().item()
            failures.append((seed, errors, grad_error, share))
    print(f"worst forward error over 200 seeds: {worst}")
    assert not failures, failures


def _chunk_case(batch, q_len, k_len, heads, head_dim, dtype, q_start, k_start, shuffle, seed):
    """q, k, v as ring attention gives them to the chunk kernel: strided views
    of one fused [B, S, 3, H, D] projection, with global positions (shuffled
    keys, if asked: the kernel masks each key by its own position)."""
    device = _require_cuda()
    gen = torch.Generator(device=device).manual_seed(seed)
    proj = torch.randn((batch, max(q_len, k_len), 3, heads, head_dim), generator=gen,
                       device=device).to(dtype)
    q_pos = torch.arange(q_start, q_start + q_len, dtype=torch.int32, device=device)
    k_pos = torch.arange(k_start, k_start + k_len, dtype=torch.int32, device=device)
    if shuffle:
        k_pos = k_pos[torch.randperm(k_len, generator=gen, device=device)]
    return proj[:, :q_len, 0], proj[:, :k_len, 1], proj[:, :k_len, 2], q_pos, k_pos


# The kernel and the plain version take the same inputs widened to float32 and
# fold the same key tiles, summing in another order; their outputs are float32
# for either input dtype, so both dtypes are held at 1e-5.
@pytest.mark.cuda
@pytest.mark.parametrize("case,causal", [
    ((8, 128, 128, 4, 32, torch.float32, 128, 0, False), True),     # ring step: visible
    ((8, 128, 128, 4, 32, torch.float32, 128, 128, False), True),   # ring step: diagonal
    ((8, 128, 128, 4, 32, torch.float32, 128, 256, False), True),   # ring step: future
    ((8, 128, 128, 4, 32, torch.float32, 128, 256, False), False),
    ((2, 256, 128, 2, 32, torch.float32, 0, 128, False), True),     # future for one row block
    ((2, 100, 60, 2, 32, torch.float32, 40, 30, False), True),      # Sq != Sk
    ((3, 33, 45, 2, 16, torch.float32, 7, 0, True), True),          # ragged, shuffled keys
    ((5, 1, 7, 3, 64, torch.float32, 3, 0, False), True),
    ((1, 128, 128, 1, 64, torch.bfloat16, 0, 0, False), True),
    ((2, 80, 100, 2, 32, torch.float32, 20, 30, True), True),       # two key tiles, shuffled
    ((3, 33, 70, 2, 16, torch.float32, 0, 40, True), True),         # wholly future, ragged
    # Head dims 8 and 128 and float16 (C6).
    ((8, 128, 128, 4, 8, torch.float32, 128, 0, False), True),
    ((2, 80, 100, 2, 8, torch.bfloat16, 20, 30, True), True),
    ((2, 128, 128, 2, 128, torch.float32, 128, 128, False), True),
    ((2, 100, 60, 2, 128, torch.float16, 40, 30, False), False),
    ((8, 128, 128, 4, 32, torch.float16, 128, 0, False), True),
    # Head dim 256 (C8), in all three dtypes; a 4-row chunk at D = 128 and 256.
    ((2, 128, 128, 2, 256, torch.float32, 128, 128, False), True),
    ((4, 4, 4, 2, 128, torch.float32, 4, 0, False), True),
    ((4, 4, 8, 2, 256, torch.float32, 4, 0, False), True),
    ((2, 80, 100, 2, 256, torch.bfloat16, 20, 30, True), True),
    ((2, 100, 60, 2, 256, torch.float16, 40, 30, False), False),
])
def test_chunk_kernel_matches_plain_version(case, causal):
    q, k, v, q_pos, k_pos = _chunk_case(*case, seed=sum(case[:5]))
    before = fac.KERNEL.launches
    got = fac.chunk_kernel(q, k, v, q_pos, k_pos, causal)
    torch.cuda.synchronize()
    assert fac.KERNEL.launches == before + 1
    want = fac.plain_flash_attention_chunk(q, k, v, q_pos, k_pos, causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape and g.is_contiguous()
    assert max(fac.chunk_errors(got, want)) <= 1e-5
    if causal and case[7] >= case[6] + case[1]:  # wholly in the future: the proxy stats
        assert not any(x.any() for x in got)


@pytest.mark.cuda
def test_kernels_refuse_unaligned_rows():
    # The kernels move rows as 16-byte pieces: a view 4 bytes into its buffer
    # is refused before any launch, by the forward and the chunk kernel alike.
    device = _require_cuda()
    flat = torch.randn(2 * 16 * 2 * 32 + 1, device=device)
    q = flat[1:].view(2, 16, 2, 32)
    k, v = (x.contiguous() for x in (q, q))
    positions = torch.arange(16, dtype=torch.int32, device=device)
    before = (fa.FORWARD.launches, fac.KERNEL.launches)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa.forward_kernel(q, k, v, True)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fac.chunk_kernel(q, k, v, positions, positions, True)
    assert (fa.FORWARD.launches, fac.KERNEL.launches) == before


@pytest.mark.cuda
def test_chunk_kernel_rejects_what_it_cannot_take():
    q, k, v, q_pos, k_pos = _chunk_case(2, 16, 16, 2, 32, torch.float32, 0, 0, False, seed=0)
    with pytest.raises(ValueError, match="head dims"):  # the dispatch pads 24 to 32
        fac.chunk_kernel(*(x[..., :24] for x in (q, k, v)), q_pos, k_pos)
    with pytest.raises(TypeError):
        fac.chunk_kernel(q.double(), k.double(), v.double(), q_pos, k_pos)
    with pytest.raises(ValueError, match="int32 k_positions"):
        fac.chunk_kernel(q, k, v, q_pos, k_pos.long())
    with pytest.raises(ValueError, match="one CUDA device"):
        fac.chunk_kernel(q, k, v, q_pos.cpu(), k_pos)


# C6 and C8: on CUDA, attention at every head dim up to 256 and in float16
# runs through the kernels, as the TPU kernel takes any head dim and float
# dtype: head dims 8 to 256 as built, any other zero-padded to the next built
# one.
# float32 is held at 2e-5 against the CPU's full attention, the attention
# tolerance; float16 against the CPU's float32 attention on the same float16
# inputs at 2e-3 absolute and relative (the kernel computes in fp32 and rounds
# once to float16: within a float16 ulp).
def _c6_want(q, k, v):
    return full_attention(*(x.cpu().double() for x in (q, k, v)), causal=True).float()


def _c6_tolerance(dtype):
    return {"rtol": 0.0, "atol": 2e-5} if dtype == torch.float32 else {"rtol": 2e-3, "atol": 2e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,dtype", [(8, torch.float32), (32, torch.float16),
                                            (128, torch.float32), (24, torch.float32),
                                            (100, torch.float16), (200, torch.float32),
                                            (256, torch.float32), (256, torch.float16)])
def test_best_attention_at_any_head_dim_runs_the_kernel_on_the_card(head_dim, dtype):
    device = _require_cuda()
    q, k, v = _qkv((4, 16, 2, head_dim), dtype, device, seed=head_dim)
    before = fa.FORWARD.launches
    got = best_attention(q, k, v, causal=True)
    assert fa.FORWARD.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.cpu().float(), _c6_want(q, k, v), **_c6_tolerance(dtype))


# C8 past 256: every wider head dim runs the wide kernels
# (kernels/flash_attention_wide.py), one forward launch a call, nothing of the
# narrow kernels, within 2e-5 of the CPU's float32 attention.
@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [257, 384, 512, 1000])
def test_best_attention_past_head_dim_256_runs_the_wide_kernel_on_the_card(head_dim):
    device = _require_cuda()
    q, k, v = _qkv((2, 20, 2, head_dim), torch.float32, device, seed=head_dim)
    before = [c.launches for c in fa.COUNTERS + wide.COUNTERS]
    got = best_attention(q, k, v, causal=True)
    assert [c.launches - b for c, b in zip(fa.COUNTERS + wide.COUNTERS, before)] == [
        0, 0, 1, 0, 0]
    torch.testing.assert_close(got.cpu(), _c6_want(q, k, v), rtol=0, atol=2e-5)


# Each wide kernel against its plain version on the same inputs (the plain
# version on CPU copies), at head dims 257 (rows that are not whole 16-byte
# pieces: the element-wise copies), 384, 512 (the widest one-slice head dim),
# 513 (two 512-column output slices) and 1000, in the three dtypes, causal and
# not, with ragged tiles (S = 40: three 16-row and 16-key tiles), q, k, v
# strided views of one fused projection. Tolerances as the narrow kernels'
# (`_atol`); the backward's 16-bit outputs also relative, B3's pv and l
# relative to l.
WIDE_CASES = [(d, dtype) for d in (257, 384, wide.WIDE_SLICE, wide.WIDE_SLICE + 1, 1000)
              for dtype in (torch.float32, torch.bfloat16, torch.float16)]


def _qkv_views(shape, dtype, device, seed=0):
    """q, k, v as the main path gives them: views of one [B, S, 3, H, D] projection."""
    batch, seq, heads, head_dim = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    proj = torch.randn((batch, seq, 3, heads, head_dim), generator=gen, device=device).to(dtype)
    return proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim,dtype", WIDE_CASES)
def test_wide_kernels_match_plain_versions(head_dim, dtype, causal):
    device = _require_cuda()
    q, k, v = _qkv_views((2, 40, 2, head_dim), dtype, device, seed=head_dim)
    cpu = [x.cpu() for x in (q, k, v)]
    o, lse = wide.forward_kernel(q, k, v, causal, need_lse=True)
    want_o, want_lse = wide.plain_wide_forward(*cpu, causal, need_lse=True)
    torch.testing.assert_close(o.cpu().float(), want_o.float(), rtol=0, atol=_atol(dtype))
    torch.testing.assert_close(lse.cpu(), want_lse, rtol=0, atol=1e-5)
    dout = torch.randn(q.shape, generator=torch.Generator(device=device).manual_seed(3),
                       device=device).to(dtype)
    got = wide.backward_kernel(q, k, v, o, lse, dout, causal)
    want = wide.plain_wide_backward(*cpu, o.cpu(), lse.cpu(), dout.cpu(), causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == q.shape
        tol = 1e-5 if dtype == torch.float32 else _atol(dtype)
        torch.testing.assert_close(g.cpu().float(), w.float(), rtol=tol,
                                   atol=tol * max(1.0, w.float().abs().max().item()))
    q_pos = torch.arange(24, 64, dtype=torch.int32)
    k_pos = torch.randperm(40, generator=torch.Generator().manual_seed(1)).to(torch.int32)
    got = wide.chunk_kernel(q, k, v, q_pos.to(device), k_pos.to(device), causal)
    want = wide.plain_wide_chunk(*cpu, q_pos, k_pos, causal)
    assert max(fac.chunk_errors(tuple(x.cpu() for x in got), want)) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_wide_kernels_are_deterministic_and_reject_what_they_cannot_take():
    device = _require_cuda()
    q, k, v = _qkv((4, 70, 2, 300), torch.float32, device)
    o, lse = wide.forward_kernel(q, k, v, True, need_lse=True)
    assert torch.equal(o, wide.forward_kernel(q, k, v, True)[0])
    first = wide.backward_kernel(q, k, v, o, lse, o, True)
    assert all(torch.equal(a, b) for a, b in zip(first, wide.backward_kernel(
        q, k, v, o, lse, o, True)))
    pos = torch.arange(70, dtype=torch.int32, device=device)
    first = wide.chunk_kernel(q, k, v, pos, pos, True)
    assert all(torch.equal(a, b) for a, b in zip(first, wide.chunk_kernel(q, k, v, pos, pos, True)))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        wide.forward_kernel(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="head dim of q, k, v contiguous"):
        wide.forward_kernel(q.transpose(1, 3), k.transpose(1, 3), v.transpose(1, 3))
    with pytest.raises(ValueError, match="contiguous float32 lse"):
        wide.backward_kernel(q, k, v, o, lse[:, :, :10], o)


# The path the wide route serves: one ff_trans_ppo update at its default
# width with 2 heads of 512 (d_model 1024) launches 130 wide forwards and 64
# wide backwards and nothing of the narrow kernels or the chunk kernels.
@pytest.mark.cuda
def test_ff_trans_ppo_update_at_two_heads_of_512_runs_only_the_wide_kernels():
    from stoix_tpu_torch import envs
    from stoix_tpu_torch.systems.ppo.anakin import ff_trans_ppo
    from stoix_tpu_torch.utils import config as config_lib
    from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
    device = _require_cuda()
    config = check_total_timesteps(config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_trans_ppo.yaml",
        ["system.head_dim=512", "system.num_heads=2", "system.multistep_impl=pallas",
         "logger.use_console=False"]), 1)
    env, _ = envs.make(config)
    setup = ff_trans_ppo.learner_setup(env, config, device, seed=int(config.arch.seed))
    counters = fa.COUNTERS + (fac.KERNEL,) + wide.COUNTERS
    before = [c.launches for c in counters]
    _, (_, losses) = setup.learn.update_step(setup.learner_state)
    torch.cuda.synchronize()
    launches = {c.name: c.launches - b for c, b in zip(counters, before)}
    assert launches == {**dict.fromkeys(launches, 0), wide.FORWARD.name: 130,
                        wide.BACKWARD.name: 64}
    assert all(bool(torch.isfinite(x).all()) for x in losses.values())


# The torso and the one-rank ring at D = 384 through the wide kernels (one
# forward and one backward launch a torso step, one chunk launch a ring step),
# against the CPU, tolerances as at D = 256 above.
@pytest.mark.cuda
def test_transformer_torso_trains_through_the_wide_kernels():
    device = _require_cuda()
    torso = TransformerTorso(5, 1, 2, 384, 32, generator=torch.Generator().manual_seed(0))
    x = torch.randn((3, 4, 5), generator=torch.Generator().manual_seed(1))
    want, want_grads = _torso_reference(torso, x)
    before = [c.launches for c in fa.COUNTERS + wide.COUNTERS]
    got = torso.to(device)(x.to(device))
    (got ** 2).sum().backward()
    assert [c.launches - b for c, b in zip(fa.COUNTERS + wide.COUNTERS, before)] == [
        0, 0, 1, 1, 0]
    torch.testing.assert_close(got.cpu(), want.detach(), rtol=0, atol=1e-4)
    for p, w in zip(torso.parameters(), want_grads):
        torch.testing.assert_close(p.grad.cpu(), w, rtol=1e-4, atol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [8, 24])
def test_transformer_torso_trains_through_the_kernels_at_small_head_dims(head_dim):
    device = _require_cuda()
    torso = TransformerTorso(5, 1, 2, head_dim, 32, generator=torch.Generator().manual_seed(0))
    x = torch.randn((3, 4, 5), generator=torch.Generator().manual_seed(1))
    want, want_grads = _torso_reference(torso, x)
    before = [c.launches for c in fa.COUNTERS]
    got = torso.to(device)(x.to(device))
    (got ** 2).sum().backward()
    assert [c.launches - b for c, b in zip(fa.COUNTERS, before)] == [1, 1]
    # Dense layers sum in another order on the card: 1e-4, chip_smoke.py's torso tolerance.
    torch.testing.assert_close(got.cpu(), want.detach(), rtol=0, atol=1e-4)
    for p, w in zip(torso.parameters(), want_grads):
        torch.testing.assert_close(p.grad.cpu(), w, rtol=1e-4, atol=1e-4)


# C8: the torso at head dims 200 (padded to 256) and 256, 2 heads: its layers
# are 400 to 512 wide, 25 to 32 times D = 8's, and the card's sums in another
# order (the dense layers' and the kernels') part the gradients by up to about
# 1.5e-4 from the CPU's: 5e-4 absolute and 1e-4 relative; the output at 1e-4.
@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [200, 256])
def test_transformer_torso_trains_through_the_kernels_at_wide_head_dims(head_dim):
    device = _require_cuda()
    torso = TransformerTorso(5, 1, 2, head_dim, 32, generator=torch.Generator().manual_seed(0))
    x = torch.randn((3, 4, 5), generator=torch.Generator().manual_seed(1))
    want, want_grads = _torso_reference(torso, x)
    before = [c.launches for c in fa.COUNTERS]
    got = torso.to(device)(x.to(device))
    (got ** 2).sum().backward()
    assert [c.launches - b for c, b in zip(fa.COUNTERS, before)] == [1, 1]
    torch.testing.assert_close(got.cpu(), want.detach(), rtol=0, atol=1e-4)
    for p, w in zip(torso.parameters(), want_grads):
        torch.testing.assert_close(p.grad.cpu(), w, rtol=1e-4, atol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,dtype", [(8, torch.float32), (32, torch.float16),
                                            (24, torch.float32), (200, torch.float32),
                                            (256, torch.float16), (257, torch.float32),
                                            (384, torch.float32), (1000, torch.float16)])
def test_one_rank_ring_at_any_head_dim_runs_the_chunk_kernel_on_the_card(
        tmp_path, head_dim, dtype):
    device = _require_cuda()
    config = Config.from_dict({"arch": {"distributed": {
        "coordinator_address": f"file://{tmp_path / 'store'}", "num_processes": 1,
        "process_id": 0}}})
    parallel.maybe_initialize_distributed(config, device="cuda")
    try:
        group = parallel.create_mesh({"data": 1}, device="cuda").get_group("data")
        q, k, v = _qkv((2, 32, 2, head_dim), dtype, device, seed=head_dim + 1)
        kernel = wide.CHUNK if head_dim > 256 else fac.KERNEL
        before = kernel.launches
        got = ring_attention(q, k, v, group, causal=True)
        assert kernel.launches == before + 1
    finally:
        dist.destroy_process_group()
    assert got.dtype == dtype
    torch.testing.assert_close(got.cpu().float(), _c6_want(q, k, v), **_c6_tolerance(dtype))


# A7b on the card: ff_ppo with the main path's knobs on (U = 2), saved after
# window 1, loaded and continued, ends bitwise equal to the unbroken run; one
# GAE launch an update at U = 2.
@pytest.mark.cuda
def test_knobs_resume_is_bitwise_the_unbroken_run_on_the_card(tmp_path, monkeypatch):
    _require_cuda()
    from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
    from stoix_tpu_torch.utils import checkpointing
    from stoix_tpu_torch.utils import config as config_lib

    monkeypatch.chdir(tmp_path)
    base = ["env=identity_game", "arch.total_num_envs=16", "arch.num_eval_episodes=4",
            "arch.absolute_metric=False", "system.rollout_length=4", "system.epochs=2",
            "system.num_minibatches=2", "logger.use_console=False",
            "system.multistep_impl=pallas", "system.normalize_observations=true",
            "arch.update_batch_size=2", "system.update_guard=skip", "system.fused_update=true",
            "logger.checkpointing.save_model=true", "logger.checkpointing.save_args.max_to_keep=~"]

    def run(uid, updates, windows, *extra):
        config = config_lib.compose(config_lib.default_config_dir(),
                                    "default/anakin/default_ff_ppo.yaml", base + [
            f"logger.checkpointing.save_args.checkpoint_uid={uid}",
            f"arch.num_updates={updates}", f"arch.num_evaluation={windows}", *extra])
        ff_ppo.run_experiment(config, device="cuda")

    before = lr.GAE_KERNEL.launches
    run("unbroken", 4, 2)
    assert lr.GAE_KERNEL.launches - before == 4
    run("first", 2, 1)
    run("resumed", 2, 1, "logger.checkpointing.load_model=true",
        "logger.checkpointing.load_args.checkpoint_uid=first")
    step = 4 * 4 * 16
    load = lambda uid: torch.load(  # noqa: E731
        tmp_path / "checkpoints" / uid / "ff_ppo" / str(step) / checkpointing.STATE_FILE,
        weights_only=True)
    unbroken, resumed = load("unbroken"), load("resumed")
    assert unbroken.keys() == resumed.keys()
    for key, value in unbroken.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, resumed[key]), key
        elif isinstance(value, dict):
            assert torch.equal(value["generator_state"], resumed[key]["generator_state"]), key
        else:
            assert value == resumed[key], key


# ----------------------------------------------------------------- the value-based family


def _q_network(head_kind: str = "dqn", use_layer_norm: bool = False):
    from stoix_tpu_torch.networks import base, heads, inputs, torso
    gen = torch.Generator().manual_seed(0)
    head = {"dqn": lambda: heads.DiscreteQNetworkHead(3, 16, generator=gen),
            "c51": lambda: heads.DistributionalDiscreteQNetwork(3, 16, num_atoms=11, vmin=-5.0,
                                                                vmax=5.0, generator=gen)}[head_kind]
    return base.FeedForwardActor(head(), torso.MLPTorso(5, (16, 16), use_layer_norm=use_layer_norm,
                                                        generator=gen), inputs.ObservationInput())


def _observations(lead, seed):
    from stoix_tpu_torch.envs.types import Observation
    gen = torch.Generator().manual_seed(seed)
    return Observation(torch.randn(lead + (5,), generator=gen), torch.ones(lead + (3,)),
                       torch.zeros(lead, dtype=torch.int32))


def _to(tree, device):
    from stoix_tpu_torch.utils.tree import tree_map
    return tree_map(lambda x: x.to(device), tree)


@pytest.mark.cuda
def test_item_buffer_on_the_card_matches_the_cpu():
    from stoix_tpu_torch.buffers import make_item_buffer
    device = _require_cuda()
    buf = make_item_buffer(max_length=50, min_length=8, sample_batch_size=64)
    item = {"obs": torch.zeros(3), "action": torch.zeros((), dtype=torch.int32)}
    on_card, on_cpu = buf.init(_to(item, device)), buf.init(item)
    gen = torch.Generator().manual_seed(0)
    for size in (20, 12, 12, 12, 7):
        batch = {"obs": torch.randn((size, 3), generator=gen),
                 "action": torch.randint(0, 4, (size,), generator=gen, dtype=torch.int32)}
        on_card, on_cpu = buf.add(on_card, _to(batch, device)), buf.add(on_cpu, batch)
    assert (on_card.insert_pos, on_card.num_added) == (on_cpu.insert_pos, on_cpu.num_added)
    indices = buf.sample_indices(on_card, torch.Generator(device=device).manual_seed(1))
    assert indices.device.type == "cuda" and int(indices.max()) < 50
    got = buf.gather(on_card, indices).experience
    want = buf.gather(on_cpu, indices.cpu()).experience
    assert all(torch.equal(got[k].cpu(), want[k]) for k in want)


@pytest.mark.cuda
@pytest.mark.parametrize("head_kind", ["dqn", "c51"])
def test_dqn_update_step_on_the_card_matches_the_cpu(head_kind):
    # One update_from_batch (loss, gradients, clip + Adam, Polyak) of ff_dqn
    # and of ff_c51 on the same explicit batch and params: 1e-5 absolute (the
    # dense layers sum in another order on the card; the MLP torso computes
    # in float32, so this reference stays float32).
    from stoix_tpu_torch.base_types import OnlineAndTarget, Transition
    from stoix_tpu_torch.systems.q_learning import ff_c51, ff_dqn, q_family
    from stoix_tpu_torch.utils import config as config_lib
    from stoix_tpu_torch.utils.training import ClipAdam
    device = _require_cuda()
    name = "ff_dqn" if head_kind == "dqn" else "ff_c51"
    loss_fn = ff_dqn.dqn_loss if head_kind == "dqn" else ff_c51.c51_loss
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             f"default/anakin/default_{name}.yaml", [])
    gen = torch.Generator().manual_seed(2)
    batch = Transition(_observations((64,), 3), torch.randint(0, 3, (64,), generator=gen),
                       torch.randn(64, generator=gen), torch.rand(64, generator=gen) < 0.2,
                       _observations((64,), 4), {})
    results = []
    for dev in ("cpu", device):
        net = _q_network(head_kind).to(dev)
        online = {k: v.detach() for k, v in net.named_parameters()}
        target = {k: v * 0.5 for k, v in online.items()}
        optim = ClipAdam(1e-3, 0.5, eps=1e-5)
        update = q_family.QUpdate(loss_fn, q_family.make_q_apply(net), optim, cfg)
        params, opt = [OnlineAndTarget(online, target)], [optim.init(online)]
        for _ in range(2):
            params, opt, info = update(params, opt, [_to(batch, dev)])
        results.append((params[0], info["q_loss"]))
    (cpu_params, cpu_loss), (card_params, card_loss) = results
    torch.testing.assert_close(card_loss.cpu(), cpu_loss, rtol=1e-5, atol=0)
    for side in (0, 1):
        for k, v in cpu_params[side].items():
            torch.testing.assert_close(card_params[side][k].cpu(), v, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_pqn_update_step_on_the_card_matches_the_cpu():
    # ff_pqn's update on one explicit trajectory with given permutations:
    # Q(lambda) targets through B1's generic kernel (one launch) on the card
    # against `scan` on the CPU (1e-6: the network's max Q in another
    # summation order), then 2 x 2 clip + RAdam steps: params 1e-5 absolute.
    from stoix_tpu_torch.systems.q_learning import ff_pqn, q_family
    from stoix_tpu_torch.utils import config as config_lib
    from stoix_tpu_torch.utils.training import ClipRAdam
    device = _require_cuda()
    cfg = config_lib.compose(config_lib.default_config_dir(), "default/anakin/default_ff_pqn.yaml",
                             ["system.epochs=2", "system.num_minibatches=2", "arch.num_updates=4",
                              "arch.num_updates_per_eval=1"])
    gen = torch.Generator().manual_seed(5)
    discount = (torch.rand((8, 16), generator=gen) > 0.2).float()
    traj = ff_pqn.PQNTransition(
        _observations((8, 16), 6), torch.randint(0, 3, (8, 16), generator=gen),
        torch.randn((8, 16), generator=gen), discount,
        (torch.rand((8, 16), generator=gen) < 0.2) & (discount != 0), _observations((8, 16), 7),
        {})
    perms = [torch.randperm(128, generator=gen) for _ in range(2)]
    results = []
    for dev, impl in (("cpu", "scan"), (device, "pallas")):
        net = _q_network(use_layer_norm=True).to(dev)
        optim = ClipRAdam(5e-3, 0.5)
        learner = ff_pqn.PQNLearner(None, q_family.make_q_apply(net), optim, cfg)
        params = {k: v.detach() for k, v in net.named_parameters()}
        before = lr.KERNEL.launches
        with multistep.scan_kernels.use_impl(impl):
            out = learner.update(params, (optim.init(params), ff_pqn.PQNStepCount(0)),
                                 _to(traj, dev), None, permutations=perms)
        results.append(out)
        if dev == device:
            assert lr.KERNEL.launches == before + 1
    (cpu_params, _, _, cpu_targets), (card_params, card_opt, _, card_targets) = results
    torch.testing.assert_close(card_targets.cpu(), cpu_targets, rtol=0, atol=1e-6)
    for k, v in cpu_params.items():
        torch.testing.assert_close(card_params[k].cpu(), v, rtol=0, atol=1e-5)
    assert ff_pqn.find_step_count(card_opt) == 4


# ------------------------------------------------- the continuous PPO family and rec_ppo


def _continuous_actor_critic(head_name: str):
    from stoix_tpu_torch.networks import base, heads, inputs, torso
    gen = torch.Generator().manual_seed(0)
    kwargs = {} if head_name == "MultivariateNormalDiagHead" else dict(minimum=-2.0, maximum=2.0)
    actor = base.FeedForwardActor(getattr(heads, head_name)(2, 16, generator=gen, **kwargs),
                                  torso.MLPTorso(5, (16, 16), generator=gen),
                                  inputs.ObservationInput())
    critic = base.FeedForwardCritic(heads.ScalarCriticHead(16, generator=gen),
                                    torso.MLPTorso(5, (16, 16), generator=gen),
                                    inputs.ObservationInput())
    return actor, critic


def _ppo_family_update(system: str, device, head_name: str):
    """One ff_ppo-learner update of `system` on an explicit [8, 16]
    trajectory of float actions with given permutations, under
    multistep_impl pallas on the card and scan on the CPU."""
    from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams, PPOTransition
    from stoix_tpu_torch.systems.ppo.anakin import ff_dpo_continuous, ff_ppo, ff_ppo_penalty
    from stoix_tpu_torch.utils import config as config_lib
    loss_fn = {"ff_ppo_continuous": None, "ff_ppo_penalty_continuous":
               ff_ppo_penalty.penalty_policy_loss,
               "ff_dpo_continuous": ff_dpo_continuous.dpo_policy_loss}[system]
    impl = "pallas" if torch.device(device).type == "cuda" else "scan"
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             f"default/anakin/default_{system}.yaml",
                             ["system.epochs=2", "system.num_minibatches=2",
                              "arch.num_updates_per_eval=1", f"system.multistep_impl={impl}"])
    gen = torch.Generator().manual_seed(5)
    done = torch.rand((8, 16), generator=gen) < 0.1
    traj = PPOTransition(done, (torch.rand((8, 16), generator=gen) < 0.1) & ~done,
                         torch.rand((8, 16, 2), generator=gen) * 3.8 - 1.9,
                         torch.randn((8, 16), generator=gen), torch.randn((8, 16), generator=gen),
                         torch.zeros((8, 16)), _observations((8, 16), 6), _observations((8, 16), 7),
                         {})
    actor, critic = (net.to(device) for net in _continuous_actor_critic(head_name))
    apply = (ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic))
    with torch.no_grad():
        traj = traj._replace(log_prob=apply[0]({k: v for k, v in actor.named_parameters()},
                                               _to(traj.obs, device)).log_prob(
            traj.action.to(device)).cpu())
    params = ActorCriticParams({k: v.detach() for k, v in actor.named_parameters()},
                               {k: v.detach() for k, v in critic.named_parameters()})
    optims = ff_ppo.make_optimizers(cfg)
    opt = ActorCriticOptStates(optims[0].init(params.actor_params),
                               optims[1].init(params.critic_params))
    learner = ff_ppo.get_learner_fn(None, apply, optims, cfg, loss_fn)
    perms = [torch.randperm(128, generator=gen) for _ in range(2)]
    return learner.update(params, opt, _to(traj, device), permutations=perms,
                          kl_beta=torch.tensor(3.0, device=device))


def _assert_update_matches(card, cpu):
    torch.testing.assert_close(card.advantages.cpu(), cpu.advantages, rtol=0, atol=1e-6)
    for key, value in cpu.loss_info.items():
        torch.testing.assert_close(card.loss_info[key].cpu(), value, rtol=1e-5, atol=1e-7)
    for side in (0, 1):
        for k, v in cpu.params[side].items():
            torch.testing.assert_close(card.params[side][k].cpu(), v, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("system,head_name", [
    ("ff_ppo_continuous", "NormalAffineTanhDistributionHead"),
    ("ff_ppo_penalty_continuous", "NormalAffineTanhDistributionHead"),
    ("ff_ppo_penalty_continuous", "MultivariateNormalDiagHead"),
    ("ff_dpo_continuous", "BetaDistributionHead"),
])
def test_continuous_update_step_on_the_card_matches_the_cpu(system, head_name):
    # As the ff_pqn card test: advantages 1e-6 absolute (B1's GAE entry, one
    # launch, against `scan` on the CPU), losses 1e-5 relative, params 1e-5
    # absolute after 2 x 2 clip + Adam steps.
    device = _require_cuda()
    cpu = _ppo_family_update(system, "cpu", head_name)
    before = (lr.KERNEL.launches, lr.GAE_KERNEL.launches)
    card = _ppo_family_update(system, device, head_name)
    assert (lr.KERNEL.launches, lr.GAE_KERNEL.launches) == (before[0], before[1] + 1)
    _assert_update_matches(card, cpu)


def _rec_update(device, cell_type: str, update_batch: int):
    """One rec_ppo update on an explicit [8, 8 U] trajectory of sequences
    (stored carries, reset flags, the actor's own log-probs) with given env
    permutations, multistep_impl pallas on the card and scan on the CPU."""
    from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams
    from stoix_tpu_torch.networks import base, heads, inputs, torso
    from stoix_tpu_torch.systems.ppo.anakin import ff_ppo, rec_ppo
    from stoix_tpu_torch.utils import config as config_lib
    from stoix_tpu_torch.utils.tree import tree_stack
    impl = "pallas" if torch.device(device).type == "cuda" else "scan"
    cfg = config_lib.compose(config_lib.default_config_dir(), "default/anakin/default_rec_ppo.yaml",
                             ["system.epochs=2", "system.num_minibatches=2",
                              "arch.num_updates_per_eval=1", f"system.multistep_impl={impl}",
                              f"arch.update_batch_size={update_batch}"])
    gen = torch.Generator().manual_seed(0)

    def network(kind):
        head = (heads.CategoricalHead(3, 16, generator=gen) if kind == "actor"
                else heads.ScalarCriticHead(16, generator=gen))
        parts = (base.ScannedRNN(16, 16, cell_type, generator=gen),
                 torso.MLPTorso(5, (16,), generator=gen), torso.MLPTorso(16, (16,), generator=gen),
                 inputs.ObservationInput())
        cls = base.RecurrentActor if kind == "actor" else base.RecurrentCritic
        return cls(head, *parts).to(device)

    actor, critic = network("actor"), network("critic")
    t_len, n_envs = 8, 8 * update_batch
    data = torch.Generator().manual_seed(4)
    carry = lambda: torch.randn((t_len, n_envs, 16), generator=data)  # noqa: E731
    hstates = tuple((carry(), carry()) if cell_type == "lstm" else carry() for _ in range(2))
    entering = torch.rand((t_len, n_envs), generator=data) < 0.15
    done = torch.rand((t_len, n_envs), generator=data) < 0.1
    obs = _observations((t_len, n_envs), 8)
    action = torch.randint(0, 3, (t_len, n_envs), generator=data)
    apply = (rec_ppo.make_apply_fn(actor), rec_ppo.make_apply_fn(critic))
    actor_params = {k: v.detach() for k, v in actor.named_parameters()}
    with torch.no_grad():  # the actor's own log-probs, on the CPU for both runs
        cpu_actor = network("actor").cpu()
        cpu_actor.load_state_dict({k: v.cpu() for k, v in actor.state_dict().items()})
        h0 = hstates[0][0] if cell_type == "gru" else tuple(h[0] for h in hstates[0])
        log_prob = cpu_actor(h0, (obs, entering))[1].log_prob(action)
    traj = rec_ppo.RNNPPOTransition(
        done, (torch.rand((t_len, n_envs), generator=data) < 0.1) & ~done, entering, action,
        torch.randn((t_len, n_envs), generator=data), torch.randn((t_len, n_envs), generator=data),
        torch.randn((t_len, n_envs), generator=data), log_prob, obs, hstates, {})
    params = ActorCriticParams(actor_params, {k: v.detach() for k, v in critic.named_parameters()})
    optims = ff_ppo.make_optimizers(cfg)
    opt = ActorCriticOptStates(optims[0].init(params.actor_params),
                               optims[1].init(params.critic_params))
    if update_batch > 1:
        params, opt = tree_stack([params] * update_batch), tree_stack([opt] * update_batch)
    learner = rec_ppo.get_learner_fn(None, apply, optims, cfg)
    perm = torch.Generator().manual_seed(9)
    perms = [torch.randperm(8, generator=perm) if update_batch == 1 else
             [torch.randperm(8, generator=perm) for _ in range(update_batch)] for _ in range(2)]
    return learner.update(params, opt, _to(traj, device), permutations=perms)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_type,update_batch", [("gru", 1), ("gru", 2), ("lstm", 1)])
def test_rec_ppo_update_step_on_the_card_matches_the_cpu(cell_type, update_batch):
    # The re-unrolled GRU/LSTM losses, GAE through B1's GAE entry (one launch
    # an update at any U), 2 x 2 clip + Adam steps: as the test above.
    device = _require_cuda()
    cpu = _rec_update("cpu", cell_type, update_batch)
    before = (lr.KERNEL.launches, lr.GAE_KERNEL.launches)
    card = _rec_update(device, cell_type, update_batch)
    assert (lr.KERNEL.launches, lr.GAE_KERNEL.launches) == (before[0], before[1] + 1)
    _assert_update_matches(card, cpu)


@pytest.mark.cuda
def test_beta_sampling_with_a_cuda_generator_repeats_from_its_seed():
    # torch._standard_gamma draws from the CUDA generator it is given: the
    # same seed gives the same draws, another seed other draws, and the
    # draws' mean is the Beta's (five standard errors).
    from stoix_tpu_torch.ops.distributions import AffineBeta
    device = _require_cuda()
    alpha = torch.tensor([0.7, 2.0, 5.0], device=device).expand(100_000, 3)
    beta = torch.tensor([0.6, 2.0, 1.2], device=device).expand(100_000, 3)
    dist = AffineBeta(alpha, beta, -2.0, 2.0)
    draw = lambda seed: dist.sample(torch.Generator(device=device).manual_seed(seed))  # noqa: E731
    first = draw(3)
    assert first.device.type == "cuda"
    assert torch.equal(first, draw(3)) and not torch.equal(first, draw(4))
    mean = alpha[0] / (alpha[0] + beta[0])
    var = mean * (1 - mean) / (alpha[0] + beta[0] + 1)
    unit = (first.double() + 2.0) / 4.0
    assert bool(((unit.mean(0) - mean).abs() < 5 * (var / 100_000).sqrt()).all())


# ------------------------------------------------- sequence replay: ff_rainbow and rec_r2d2


@pytest.mark.cuda
@pytest.mark.parametrize("period", [1, 4])
def test_prioritised_buffer_on_the_card_matches_the_cpu(period):
    # Adds with wraparound, add's max-priority slots, and a sample from the
    # same uniforms on a table whose float32 sums are exact (small integers,
    # quarters): everything exact but the probabilities (1e-6 relative).
    from stoix_tpu_torch.buffers import make_prioritised_trajectory_buffer
    device = _require_cuda()
    buf = make_prioritised_trajectory_buffer(add_batch_size=3, sample_batch_size=256,
                                             sample_sequence_length=4, period=period,
                                             max_length_time_axis=16)
    item = {"obs": torch.zeros(2), "carry": (torch.zeros(3), torch.zeros((), dtype=torch.int32))}
    on_card, on_cpu = buf.init(_to(item, device)), buf.init(item)
    gen = torch.Generator().manual_seed(0)
    for length in (3, 5, 8, 9, 20):
        chunk = {"obs": torch.randn((3, length, 2), generator=gen),
                 "carry": (torch.randn((3, length, 3), generator=gen),
                           torch.randint(0, 9, (3, length), generator=gen, dtype=torch.int32))}
        on_card, on_cpu = buf.add(on_card, _to(chunk, device)), buf.add(on_cpu, chunk)
        assert torch.equal(on_card.priorities.cpu(), on_cpu.priorities)
    table = (torch.randint(0, 6, on_cpu.priorities.shape, generator=gen) * 0.25).float()
    on_card = on_card._replace(priorities=table.to(device))
    on_cpu = on_cpu._replace(priorities=table)
    uniforms = torch.rand(256, generator=gen)
    got = buf.sample_from_uniforms(on_card, uniforms.to(device))
    want = buf.sample_from_uniforms(on_cpu, uniforms)
    assert torch.equal(got.indices.cpu(), want.indices)
    for g, w in zip(_leaves(got.experience), _leaves(want.experience)):
        assert torch.equal(g.cpu(), w)
    torch.testing.assert_close(got.probabilities.cpu(), want.probabilities, rtol=1e-6, atol=0)


def _leaves(tree):
    from stoix_tpu_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


@pytest.mark.cuda
def test_set_priorities_on_the_card_is_bitwise_and_keeps_the_last_occurrence():
    # 4096 indices over 24 (row, slot) pairs: twice bitwise on the card; each
    # written entry is the card's power of its LAST occurrence's value (the
    # same vector's power: a CPU pow may round a vector lane and a scalar tail
    # apart, so each device is held to its own); the card and the CPU agree
    # to 1e-6 relative.
    from stoix_tpu_torch.buffers import make_prioritised_trajectory_buffer
    device = _require_cuda()
    buf = make_prioritised_trajectory_buffer(add_batch_size=3, sample_batch_size=8,
                                             sample_sequence_length=2, period=1,
                                             max_length_time_axis=16, priority_exponent=0.6)
    gen = torch.Generator().manual_seed(1)
    indices = torch.stack([torch.randint(0, 3, (4096,), generator=gen),
                           torch.randint(0, 8, (4096,), generator=gen)], -1)
    values = torch.randn(4096, generator=gen) * 3
    last = {}
    for position, key in enumerate(map(tuple, indices.tolist())):
        last[key] = position
    written, positions = torch.tensor(list(last)), torch.tensor(list(last.values()))
    outs = []
    for dev in (device, device, "cpu"):
        state = buf.init({"x": torch.zeros((), device=dev)})
        out = buf.set_priorities(state, indices.to(dev), values.to(dev)).priorities
        want = torch.zeros_like(out)
        want[written[:, 0], written[:, 1]] = torch.pow(
            values.to(dev).abs() + 1e-6, 0.6)[positions.to(dev)]
        assert torch.equal(out, want)
        outs.append(out.cpu())
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0], outs[2], rtol=1e-6, atol=0)


def _sequence_update(device, system: str, cell_type: str = "gru"):
    """One ff_rainbow or rec_r2d2 update epoch (twice) on explicit
    PrioritisedSamples from fixed params; Rainbow's noise drawn on the CPU
    and given to both runs."""
    from stoix_tpu_torch.base_types import OnlineAndTarget
    from stoix_tpu_torch.buffers import PrioritisedSample
    from stoix_tpu_torch.networks import base, dueling, heads, inputs, torso
    from stoix_tpu_torch.networks.layers import draw_noise
    from stoix_tpu_torch.systems.q_learning import ff_rainbow, q_family, rec_r2d2
    from stoix_tpu_torch.utils import config as config_lib
    from stoix_tpu_torch.utils.training import ClipAdam
    gen = torch.Generator().manual_seed(0)
    data = torch.Generator().manual_seed(3)
    batch = 32
    if system == "ff_rainbow":
        net = base.FeedForwardActor(
            dueling.NoisyDistributionalDuelingQNetwork(3, 16, num_atoms=11, vmin=0.0, vmax=10.0,
                                                       layer_sizes=(16,), generator=gen),
            torso.MLPTorso(5, (16,), activation="relu", generator=gen), inputs.ObservationInput())
        noise = [draw_noise(net, torch.Generator().manual_seed(10 + k)) for k in range(6)]

        class Given(ff_rainbow.NoisyQApply):
            def draw_noise(self, generator):
                return _to(noise.pop(0), device)

        apply, loss_fn, lead, overrides = Given(net.to(device)), ff_rainbow.rainbow_loss, (
            batch, 4), []
    else:
        net = rec_r2d2.RecurrentQNetwork(
            heads.DiscreteQNetworkHead(3, 16, generator=gen),
            base.ScannedRNN(16, 16, cell_type, generator=gen),
            torso.MLPTorso(5, (16,), generator=gen), torso.MLPTorso(16, (16,), generator=gen),
            inputs.ObservationInput()).to(device)
        apply, loss_fn, lead = rec_r2d2.make_apply_fn(net), rec_r2d2.r2d2_loss, (batch, 16)
        overrides = [f"network.rnn_cell_type={cell_type}"]
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             f"default/anakin/default_{system}.yaml", overrides)
    optim = ClipAdam(1e-3, 0.5, eps=1e-5)
    update = q_family.PrioritisedQUpdate(loss_fn, apply, optim, cfg)
    online = {k: v.detach() for k, v in net.named_parameters()}
    params = [OnlineAndTarget(online, {k: v * 0.5 for k, v in online.items()})]
    opt = [optim.init(online)]
    out = []
    for _ in range(2):
        experience = {"obs": _observations(lead, 5), "action": torch.randint(0, 3, lead,
                                                                              generator=data),
                      "reward": torch.randn(lead, generator=data),
                      "discount": (torch.rand(lead, generator=data) > 0.1).float()}
        if system == "rec_r2d2":
            carry = lambda: torch.randn(lead + (16,), generator=data)  # noqa: E731
            experience["done"] = torch.rand(lead, generator=data) < 0.1
            experience["hstate"] = (carry(), carry()) if cell_type == "lstm" else carry()
        sample = PrioritisedSample(experience, torch.zeros((batch, 2), dtype=torch.long),
                                   torch.rand(batch, generator=data) * 0.01 + 1e-4)
        params, opt, info, priorities = update(params, opt, [_to(sample, device)], [None])
        out.append((info["q_loss"], priorities[0]))
    return params[0], out


@pytest.mark.cuda
@pytest.mark.parametrize("system,cell_type", [("ff_rainbow", "gru"), ("rec_r2d2", "gru"),
                                              ("rec_r2d2", "lstm")])
def test_sequence_replay_update_on_the_card_matches_the_cpu(system, cell_type):
    # The loss and the new priorities 1e-5 relative, online and target params
    # 1e-5 absolute, after two epochs; no kernel launches on either path.
    device = _require_cuda()
    cpu_params, cpu_out = _sequence_update("cpu", system, cell_type)
    before = {c.name: c.launches for c in lr.COUNTERS}
    card_params, card_out = _sequence_update(device, system, cell_type)
    assert {c.name: c.launches for c in lr.COUNTERS} == before
    for (card_loss, card_prio), (cpu_loss, cpu_prio) in zip(card_out, cpu_out):
        torch.testing.assert_close(card_loss.cpu(), cpu_loss, rtol=1e-5, atol=0)
        torch.testing.assert_close(card_prio.cpu(), cpu_prio, rtol=1e-5, atol=1e-7)
    for side in (0, 1):
        for k, v in cpu_params[side].items():
            torch.testing.assert_close(card_params[side][k].cpu(), v, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("vmin,vmax,atoms", [(0.0, 10.0, 51), (0.0, 500.0, 16), (0.0, 500.0, 51)])
def test_categorical_projection_on_the_card_matches_the_cpu(vmin, vmax, atoms):
    # ROADMAP C16: source atoms past vmax (clipped to it) on supports whose
    # float32 step rounds down: the card once indexed one past the support
    # (a device-side assert at 51 atoms on [0, 10], Rainbow's IdentityGame
    # run); the share past it is dropped, as JAX drops it, and the card
    # matches the CPU to 1e-6 absolute.
    from stoix_tpu_torch.ops.losses import categorical_l2_project
    device = _require_cuda()
    gen = torch.Generator().manual_seed(atoms)
    z_q = torch.linspace(vmin, vmax, atoms)
    z_p = torch.cat([torch.rand((30, atoms), generator=gen) * vmax * 1.3 + vmin,
                     torch.full((2, atoms), vmax * 2.0)])
    probs = torch.softmax(torch.randn((32, atoms), generator=gen), -1)
    got = categorical_l2_project(z_p.to(device), probs.to(device), z_q.to(device))
    want = categorical_l2_project(z_p, probs, z_q)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)


# ------------------------------------------------------- A12: the continuous actor-critics,
# REINFORCE and AWR (one update on the card against the same update on the CPU)

A12_SMALL = ["network.actor_network.pre_torso.layer_sizes=[32,32]",
             "network.critic_network.pre_torso.layer_sizes=[32,32]", "arch.total_num_envs=8",
             "system.total_buffer_size=512", "system.total_batch_size=64",
             "arch.num_updates_per_eval=1", "system.multistep_impl=pallas"]


def _a12_setup(system, device, overrides=()):
    """The system's learner setup on `device` (its params initialised on the
    CPU from one seed, so both devices start alike) and its warm state."""
    import importlib

    from stoix_tpu_torch import envs
    from stoix_tpu_torch.utils import config as config_lib
    from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
    package = {"ff_ddpg": "ddpg", "ff_td3": "ddpg", "ff_d4pg": "ddpg", "ff_sac": "sac",
               "ff_reinforce": "vpg", "ff_awr": "awr"}[system]
    module = importlib.import_module(f"stoix_tpu_torch.systems.{package}.{system}")
    cfg = check_total_timesteps(config_lib.compose(
        config_lib.default_config_dir(), f"default/anakin/default_{system}.yaml",
        A12_SMALL + list(overrides)), 1)
    setup = module.learner_setup(envs.make(cfg)[0], cfg, torch.device(device), 3)
    if not hasattr(setup, "learner_state"):  # (setup, warmup)
        setup, warmup = setup
        return setup, warmup(setup.learner_state)
    return setup, setup.learner_state


def _a12_batch(system):
    """A CPU batch in the system's layout: a Transition of Pendulum's shapes,
    an [E, T] trajectory of CartPole's, or [B, L] sequences."""
    from stoix_tpu_torch.base_types import Transition
    from stoix_tpu_torch.envs.types import Observation
    gen = torch.Generator().manual_seed(7)

    def obs(lead, dim, actions):
        return Observation(torch.randn(lead + (dim,), generator=gen), torch.ones(lead + (actions,)),
                           torch.zeros(lead, dtype=torch.int32))

    if system == "ff_reinforce":
        lead = (32, 8)
        done = torch.rand(lead, generator=gen) < 0.1
        return {"obs": obs(lead, 4, 2), "next_obs": obs(lead, 4, 2),
                "action": torch.randint(0, 2, lead, generator=gen),
                "reward": torch.randn(lead, generator=gen), "discount": (~done).float(),
                "truncated": (torch.rand(lead, generator=gen) < 0.1) & ~done, "info": {}}
    if system == "ff_awr":
        lead = (64, 8)
        return {"obs": obs(lead, 4, 2), "action": torch.randint(0, 2, lead, generator=gen,
                                                                  dtype=torch.int32),
                "reward": torch.randn(lead, generator=gen) * 0.05,
                "discount": (torch.rand(lead, generator=gen) > 0.1).float()}
    lead = (64,)
    return Transition(obs(lead, 3, 1), torch.rand(lead + (1,), generator=gen) * 4 - 2,
                      torch.randn(lead, generator=gen) - 5, torch.rand(lead, generator=gen) < 0.1,
                      obs(lead, 3, 1), {})


def _a12_update(system, device, overrides=()):
    """One update of `system` on `device` from the same state and batch:
    (params, metrics); the off-policy systems' noise drawn on the CPU."""
    from stoix_tpu_torch.systems import anakin
    setup, state = _a12_setup(system, device, overrides)
    learner, batch = setup.learn, _to(_a12_batch(system), device)
    if system == "ff_reinforce":
        params, _, metrics = learner.update(state.params, state.opt_states, batch)
        return params, metrics
    params = anakin.split_replicas(state.params, 1)
    opts = anakin.split_replicas(state.opt_states, 1)
    update = learner.update_from_batch
    if system == "ff_awr":
        params, _, metrics = update(params, opts, [batch])
        return params[0], metrics
    noise = update.draw_noise(_a12_batch(system), torch.Generator().manual_seed(5))
    params, _, metrics = update.step(params, opts, [batch], [_to(noise, device)])
    return params[0], metrics


@pytest.mark.cuda
@pytest.mark.parametrize("system,overrides", [
    ("ff_ddpg", []), ("ff_td3", []), ("ff_d4pg", []), ("ff_sac", []),
    ("ff_sac", ["system.autotune_alpha=false"]), ("ff_reinforce", ["env=cartpole"]),
    ("ff_awr", ["env=cartpole"])])
def test_a12_update_on_the_card_matches_the_cpu(system, overrides):
    # Losses 1e-5 relative, params 1e-5 absolute; on the card REINFORCE's
    # update launches B1's GAE entry once and AWR's epoch its generic entry
    # once; the actor-critics launch no kernel.
    from stoix_tpu_torch.utils.tree import tree_leaves
    device = _require_cuda()
    cpu_params, cpu_metrics = _a12_update(system, "cpu", overrides)
    before = {c.name: c.launches for c in lr.COUNTERS}
    card_params, card_metrics = _a12_update(system, device, overrides)
    torch.cuda.synchronize()
    launched = {c.name: c.launches - before[c.name] for c in lr.COUNTERS}
    assert launched == {lr.KERNEL.name: int(system == "ff_awr"),
                        lr.GAE_KERNEL.name: int(system == "ff_reinforce")}
    for key, value in cpu_metrics.items():
        torch.testing.assert_close(card_metrics[key].cpu(), value, rtol=1e-5, atol=1e-7)
    for card, cpu in zip(tree_leaves(card_params), tree_leaves(cpu_params)):
        torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_b1_gae_entry_at_reinforce_lambda_one_matches_plain_version_bitwise():
    # ff_reinforce's launch: [32, 1024], lambda 1.0, terminations and truncations.
    device = _require_cuda()
    gen = torch.Generator(device=device).manual_seed(4)
    shape = (32, 1024)
    r, v_tm1, v_t = (torch.randn(shape, generator=gen, device=device) for _ in range(3))
    done = torch.rand(shape, generator=gen, device=device) < 0.05
    discount = 0.99 * (~done).float()
    trunc = ((torch.rand(shape, generator=gen, device=device) < 0.05) & ~done).float()
    before = lr.GAE_KERNEL.launches
    got = lr.truncated_gae(r, discount, v_tm1, v_t, trunc, 1.0)
    torch.cuda.synchronize()
    assert lr.GAE_KERNEL.launches == before + 1
    for g, w in zip(got, lr.plain_truncated_gae(r, discount, v_tm1, v_t, trunc, 1.0)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_b1_generic_entry_from_awr_batch_major_view_matches_plain_version_bitwise():
    # ff_awr's launch: lambda returns over [7, 256] from a [256, 8] batch-major
    # sample, through `lambda_returns(batch_major=True)` (one launch), against
    # the plain recurrence on the same contiguous weights and deltas.
    device = _require_cuda()
    gen = torch.Generator(device=device).manual_seed(6)
    reward, value = (torch.randn((256, 8), generator=gen, device=device) for _ in range(2))
    discount = (torch.rand((256, 8), generator=gen, device=device) > 0.1).float()
    before = lr.KERNEL.launches
    got = multistep.lambda_returns(reward[:, :-1], 0.99 * discount[:, :-1], value[:, 1:], 0.95,
                                   batch_major=True, impl="pallas")
    torch.cuda.synchronize()
    assert lr.KERNEL.launches == before + 1 and got.shape == (256, 7)
    want = multistep.lambda_returns(reward[:, :-1].cpu(), 0.99 * discount[:, :-1].cpu(),
                                    value[:, 1:].cpu(), 0.95, batch_major=True, impl="scan")
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------- MPO and V-MPO

MPO_SMALL = ["network.actor_network.pre_torso.layer_sizes=[32,32]",
             "network.critic_network.pre_torso.layer_sizes=[32,32]", "arch.total_num_envs=8",
             "system.total_buffer_size=512", "system.total_batch_size=32",
             "system.num_samples=8", "system.epochs=2", "system.actor_target_period=2",
             "arch.num_updates_per_eval=1", "system.multistep_impl=pallas"]


def _mpo_update(system, device):
    """One MPO update (one `step` on [B, L] sequences, the normals drawn on
    the CPU) or V-MPO update (two epochs on a [T, E] trajectory) on `device`
    from the same params: (params, metrics)."""
    import importlib

    from stoix_tpu_torch import envs
    from stoix_tpu_torch.envs.types import Observation
    from stoix_tpu_torch.systems import anakin
    from stoix_tpu_torch.utils import config as config_lib
    from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
    module = importlib.import_module(f"stoix_tpu_torch.systems.mpo.{system}")
    cfg = check_total_timesteps(config_lib.compose(
        config_lib.default_config_dir(), f"default/anakin/default_{system}.yaml", MPO_SMALL), 1)
    setup = module.learner_setup(envs.make(cfg)[0], cfg, torch.device(device), 3)
    continuous = system.endswith("continuous")
    obs_dim, actions = (3, 1) if continuous else (4, 2)
    gen = torch.Generator().manual_seed(7)

    def obs(lead):
        return Observation(torch.randn(lead + (obs_dim,), generator=gen),
                           torch.ones(lead + (actions,)), torch.zeros(lead, dtype=torch.int32))

    def action(lead):
        if continuous:
            return torch.rand(lead + (1,), generator=gen) * 3.8 - 1.9
        return torch.randint(0, actions, lead, generator=gen, dtype=torch.int32)

    state = setup.learner_state
    if system.startswith("ff_vmpo"):
        lead = (32, 8)
        done = torch.rand(lead, generator=gen) < 0.1
        traj = {"obs": obs(lead), "next_obs": obs(lead), "action": action(lead),
                "reward": torch.randn(lead, generator=gen), "discount": (~done).float(),
                "truncated": (torch.rand(lead, generator=gen) < 0.1) & ~done}
        params, _, metrics = setup.learn.update(state.params, state.opt_states, _to(traj, device))
        return params, metrics
    lead = (32, int(cfg.system.sample_sequence_length))
    batch = {"obs": obs(lead), "action": action(lead),
             "log_prob": torch.randn(lead, generator=gen) * 0.5 - 1.0,
             "reward": torch.randn(lead, generator=gen),
             "discount": (torch.rand(lead, generator=gen) > 0.1).float()}
    update = setup.learn.update_from_batch
    noise = update.draw_noise(batch, torch.Generator().manual_seed(5))
    params, _, metrics = update.step(anakin.split_replicas(state.params, 1),
                                     anakin.split_replicas(state.opt_states, 1),
                                     [_to(batch, device)], [_to(noise, device)])
    return params[0], metrics


@pytest.mark.cuda
@pytest.mark.parametrize("system", ["ff_mpo", "ff_mpo_continuous", "ff_vmpo",
                                    "ff_vmpo_continuous"])
def test_mpo_family_update_on_the_card_matches_the_cpu(system):
    # Losses 1e-5 relative, params and duals 1e-5 absolute; an MPO step
    # launches B1's generic entry once (Retrace), a V-MPO epoch its GAE entry
    # once; nothing else.
    from stoix_tpu_torch.utils.tree import tree_leaves
    device = _require_cuda()
    cpu_params, cpu_metrics = _mpo_update(system, "cpu")
    before = {c.name: c.launches for c in lr.COUNTERS}
    card_params, card_metrics = _mpo_update(system, device)
    torch.cuda.synchronize()
    launched = {c.name: c.launches - before[c.name] for c in lr.COUNTERS}
    vmpo = system.startswith("ff_vmpo")
    assert launched == {lr.KERNEL.name: int(not vmpo), lr.GAE_KERNEL.name: 2 * int(vmpo)}
    for key, value in cpu_metrics.items():
        torch.testing.assert_close(card_metrics[key].cpu(), value, rtol=1e-5, atol=1e-7)
    for card, cpu in zip(tree_leaves(card_params), tree_leaves(cpu_params)):
        torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("estimator", ["general", "retrace", "discounted", "importance",
                                       "vtrace"])
def test_new_estimators_on_the_card_match_the_cpu_scan_bitwise(estimator):
    # Each through the dispatch (`pallas`): one launch of B1's generic entry
    # on the card, bitwise the CPU's `scan`; Retrace at ff_mpo's [128, 8]
    # sequences (a [6, 128] recurrence) with XLA's float32 exp on the card.
    device = _require_cuda()
    gen = torch.Generator().manual_seed(9)
    rand = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    discount = 0.99 * (torch.rand((128, 8), generator=gen) > 0.1).float()
    inputs = {
        "general": (lambda *a, impl: multistep.general_off_policy_returns_from_q_and_v(
            *a, impl=impl), (rand(128, 7), rand(128, 8), rand(128, 8), discount,
                             torch.rand((128, 7), generator=gen))),
        "retrace": (lambda *a, impl: multistep.retrace_continuous(*a, 0.95, impl=impl),
                    (rand(128, 7), rand(128, 6), rand(128, 7), rand(128, 7), discount[:, :7],
                     rand(128, 6) * 0.8)),
        "discounted": (lambda *a, impl: multistep.discounted_returns(*a, impl=impl),
                       (rand(8, 128), discount.T.contiguous(), rand(8, 128))),
        "importance": (lambda *a, impl: multistep.importance_corrected_td_errors(
            a[0], a[1], a[2], 0.9, a[3], impl=impl),
            (rand(8, 128), discount.T.contiguous(), torch.exp(rand(8, 128) * 0.5), rand(9, 128))),
        "vtrace": (lambda *a, impl: multistep.vtrace_td_error_and_advantage(*a, impl=impl),
                   (rand(8, 128), rand(8, 128), rand(8, 128), discount.T.contiguous(),
                    torch.exp(rand(8, 128) * 0.5))),
    }
    fn, args = inputs[estimator]
    want = fn(*args, impl="scan")
    before = (lr.KERNEL.launches, lr.GAE_KERNEL.launches)
    got = fn(*(a.to(device) for a in args), impl="pallas")
    torch.cuda.synchronize()
    assert (lr.KERNEL.launches, lr.GAE_KERNEL.launches) == (before[0] + 1, before[1])
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_xla_exp_on_the_card_is_the_cpu_one_bitwise():
    device = _require_cuda()
    x = torch.cat([torch.randn(200_000, generator=torch.Generator().manual_seed(3)) * 3,
                   torch.linspace(-120.0, 100.0, 20_001)])
    assert torch.equal(multistep.xla_exp_f32(x.to(device)).cpu(), multistep.xla_exp_f32(x))


@pytest.mark.cuda
def test_xla_log_on_the_card_is_the_cpu_one_bitwise():
    device = _require_cuda()
    gen = torch.Generator().manual_seed(4)
    x = torch.cat([torch.rand(200_000, generator=gen), torch.exp(torch.randn(200_000,
                                                                            generator=gen) * 20),
                   torch.tensor([0.0, float("inf"), 1.0, 1e-9])])
    assert torch.equal(multistep.xla_log_f32(x.to(device)).cpu(), multistep.xla_log_f32(x))


def _tabular_search(device, policy, max_depth, batch=64, actions=4, simulations=50, states=16):
    """A search over a random tabular MDP (numpy seed 0) on `device`, its
    noise drawn on the CPU: (the tree, the policy's output)."""
    import numpy as np

    from stoix_tpu_torch.search import mcts
    rng = np.random.default_rng(0)
    table = {k: torch.from_numpy(v).to(device) for k, v in dict(
        T=rng.integers(0, states, (states, actions)), R=rng.normal(size=(states, actions)),
        D=(rng.random((states, actions)) > 0.2) * 0.99, L=rng.normal(size=(states, actions)),
        V=rng.normal(size=states)).items()}
    table = {k: v if k == "T" else v.float() for k, v in table.items()}
    root = mcts.RootFnOutput(torch.from_numpy(rng.normal(size=(batch, actions))).float().to(device),
                             torch.from_numpy(rng.normal(size=batch)).float().to(device),
                             torch.from_numpy(rng.integers(0, states, batch)).to(device))

    def recurrent_fn(params, noise, action, state):
        nxt = table["T"][state, action]
        return mcts.RecurrentFnOutput(table["R"][state, action], table["D"][state, action],
                                      table["L"][nxt], table["V"][nxt]), nxt

    noise = mcts.draw_noise(torch.Generator().manual_seed(1), batch, actions, 0.25)
    noise = mcts.SearchNoise(*(x if x is None else x.to(device) for x in noise))
    fn = mcts.muzero_policy if policy == "muzero" else mcts.gumbel_muzero_policy
    out = fn(None, noise, root, recurrent_fn, simulations, max_depth=max_depth)
    if policy == "gumbel":  # the tree the Gumbel policy searches
        k = min(16, actions)
        perturbed = noise.gumbel + root.prior_logits
        threshold = perturbed.sort(-1).values[..., -k][..., None]
        root = root._replace(prior_logits=torch.where(perturbed >= threshold, root.prior_logits,
                                                      float("-inf")))
        tree = mcts.search(None, root, recurrent_fn, simulations, max_depth, 1.25, 19652.0)
    else:
        tree = mcts.search(None, mcts._root_with_noise(root, noise.dirichlet, 0.25),
                           recurrent_fn, simulations, max_depth, 1.25, 19652.0)
    return tree, out


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["muzero", "gumbel"])
@pytest.mark.parametrize("max_depth", [50, 4])
def test_tabular_search_on_the_card_matches_the_cpu(policy, max_depth):
    # B = 64, A = 4, 50 simulations: the tree's integer arrays and the
    # actions equal, its float arrays and the weights within 1e-6 (every op
    # is exact but the softmax's 4-term sum, whose order may differ).
    device = _require_cuda()
    cpu_tree, cpu_out = _tabular_search("cpu", policy, max_depth)
    card_tree, card_out = _tabular_search(device, policy, max_depth)
    for name in ("visits", "parent", "action_from_parent", "children", "embeddings"):
        assert torch.equal(getattr(card_tree, name).cpu(), getattr(cpu_tree, name)), name
    for name in ("values", "priors", "rewards", "discounts"):
        torch.testing.assert_close(getattr(card_tree, name).cpu(), getattr(cpu_tree, name),
                                   rtol=0, atol=1e-6)
    assert torch.equal(card_out.action.cpu(), cpu_out.action)
    for name in ("action_weights", "search_value"):
        torch.testing.assert_close(getattr(card_out, name).cpu(), getattr(cpu_out, name),
                                   rtol=0, atol=1e-6)
    if max_depth == 4:
        assert bool(((cpu_tree.visits == 0) & (cpu_tree.parent >= 0)).any())  # orphans


SEARCH_SMALL = ["network.actor_network.pre_torso.layer_sizes=[32,32]",
                "network.critic_network.pre_torso.layer_sizes=[32,32]",
                "system.wm_hidden_size=32", "arch.total_num_envs=16", "system.rollout_length=8",
                "system.num_simulations=8", "system.multistep_impl=pallas",
                "system.total_buffer_size=2048", "system.total_batch_size=16"]
SEARCH_CASES = {"ff_az": ("ff_az", []), "ff_az_replay": ("ff_az", ["system.use_replay_buffer=true"]),
                "ff_mz": ("ff_mz", []), "ff_sampled_az": ("ff_sampled_az", []),
                "ff_sampled_mz": ("ff_sampled_mz", [])}


def _search_update(case, device):
    """One update (ff_az on-policy: `update` on a CPU-made rollout with fixed
    permutations) or epoch (the replay systems: `update_from_batch` on a
    CPU-made sample) of `case` on `device` from the same initial state:
    (params, metrics)."""
    import importlib

    from stoix_tpu_torch import envs
    from stoix_tpu_torch.systems import anakin
    from stoix_tpu_torch.utils import config as config_lib
    from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
    system, extra = SEARCH_CASES[case]
    module = importlib.import_module(f"stoix_tpu_torch.systems.search.{system}")
    cfg = check_total_timesteps(config_lib.compose(
        config_lib.default_config_dir(), f"default/anakin/default_{system}.yaml",
        SEARCH_SMALL + extra), 1)
    cpu = module.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 3)
    state, traj = cpu.learn.rollout(cpu.learner_state)  # made on the CPU
    setup = module.learner_setup(envs.make(cfg)[0], cfg, torch.device(device), 3)
    params = _to(state.params, device)
    opts = _to(state.opt_states, device)
    if case == "ff_az":
        perms = [torch.randperm(128, generator=torch.Generator().manual_seed(e))
                 for e in range(int(cfg.system.epochs))]
        params, _, metrics = setup.learn.update(params, opts, _to(traj, device),
                                                permutations=perms)
        return params, metrics
    batch = cpu.learn.buffer.sample(state.buffer_state, torch.Generator().manual_seed(2))
    params, _, metrics = setup.learn.update_from_batch(
        anakin.split_replicas(params, 1), anakin.split_replicas(opts, 1),
        [_to(batch.experience, device)])
    return params[0], metrics


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_search_update_on_the_card_matches_the_cpu(case):
    # Losses 1e-5 relative, params 1e-5 absolute; ff_az's update and the
    # AZ-family epochs launch B1's GAE entry once, the MuZero family none.
    from stoix_tpu_torch.utils.tree import tree_leaves
    device = _require_cuda()
    cpu_params, cpu_metrics = _search_update(case, "cpu")
    before = {c.name: c.launches for c in lr.COUNTERS}
    card_params, card_metrics = _search_update(case, device)
    torch.cuda.synchronize()
    launched = {c.name: c.launches - before[c.name] for c in lr.COUNTERS}
    assert launched == {lr.KERNEL.name: 0, lr.GAE_KERNEL.name: int("_mz" not in case)}
    for key, value in cpu_metrics.items():
        torch.testing.assert_close(card_metrics[key].cpu(), value, rtol=1e-5, atol=1e-7)
    for card, cpu in zip(tree_leaves(card_params), tree_leaves(cpu_params)):
        torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("system", ["ff_az", "ff_sampled_az"])
def test_search_step_on_the_card_matches_the_cpu(system):
    # One search from the same envs' core states and noise (drawn on the
    # CPU): the actions and visit weights equal, the root values 1e-5.
    import importlib

    from stoix_tpu_torch import envs
    from stoix_tpu_torch.systems.search import ff_az
    from stoix_tpu_torch.utils import config as config_lib
    from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
    module = importlib.import_module(f"stoix_tpu_torch.systems.search.{system}")
    device = _require_cuda()
    cfg = check_total_timesteps(config_lib.compose(
        config_lib.default_config_dir(), f"default/anakin/default_{system}.yaml", SEARCH_SMALL), 1)
    cpu = module.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 3)
    state = cpu.learner_state
    outs = []
    for where in ("cpu", device):
        setup = module.learner_setup(envs.make(cfg)[0], cfg, torch.device(where), 3)
        search = getattr(setup.learn, "acting", None) or setup.learn.search
        noise = search.draw_noise(torch.Generator().manual_seed(6), 16)
        generator = torch.Generator(device=where)
        sim_state = ff_az.simulator_state(_to(state.env_state, where), 0, 1, generator)
        obs = _to(state.timestep.observation, where)
        params = _to(state.params, where)
        if system == "ff_az":
            _, out = search(params, _to(noise, where), sim_state, obs)
            outs.append((out.action, out.action_weights, out.search_value))
        else:
            action, extras = search.act(params, _to(noise, where), sim_state, obs)
            outs.append((action, extras["search_policy"], extras["search_value"]))
    (cpu_action, cpu_weights, cpu_value), (card_action, card_weights, card_value) = outs
    assert torch.equal(card_weights.cpu(), cpu_weights)
    torch.testing.assert_close(card_action.cpu(), cpu_action, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(card_value.cpu(), cpu_value, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_search_fused_multiply_add_on_the_card_is_fma_f32_bitwise():
    # torch.addcmul on the card, one fmaf: bitwise the CPU's exact FMA on
    # random operands, on products whose sum is near a halfway point, and
    # through XLA's exp and log.
    from stoix_tpu_torch.kernels.linear_recurrence import fma_f32
    from stoix_tpu_torch.search.mcts import fused_multiply_add
    device = _require_cuda()
    gen = torch.Generator().manual_seed(8)
    a, b, c = (torch.randn(1_000_000, generator=gen) * 10 for _ in range(3))
    c[::2] = -(a[::2].double() * b[::2].double()).float()  # cancellations
    got = fused_multiply_add(a.to(device), b.to(device), c.to(device)).cpu()
    assert torch.equal(got, fma_f32(a, b, c))
    x = torch.randn(200_000, generator=gen) * 20
    assert torch.equal(multistep.xla_exp_f32(x.to(device), fused_multiply_add).cpu(),
                       multistep.xla_exp_f32(x))
    y = torch.exp(torch.randn(200_000, generator=gen) * 10)
    assert torch.equal(multistep.xla_log_f32(y.to(device), fused_multiply_add).cpu(),
                       multistep.xla_log_f32(y))


# ---------------------------------------------------------------- SPO and Disco-RL

SPO_SMALL = ["network.actor_network.pre_torso.layer_sizes=[32,32]",
             "network.critic_network.pre_torso.layer_sizes=[32,32]", "arch.total_num_envs=16",
             "system.rollout_length=8", "system.sample_sequence_length=8",
             "system.num_particles=8", "system.search_horizon=4", "system.ess_threshold=0.85",
             "system.init_log_temperature=-1.5", "system.multistep_impl=pallas",
             "system.total_buffer_size=2048", "system.total_batch_size=16"]


def _spo_setups(system, device):
    """(the CPU setup after a CPU-made rollout, its state, the setup on `device`)."""
    import importlib

    from stoix_tpu_torch import envs
    from stoix_tpu_torch.utils import config as config_lib
    from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
    module = importlib.import_module(f"stoix_tpu_torch.systems.spo.{system}")
    cfg = check_total_timesteps(config_lib.compose(
        config_lib.default_config_dir(), f"default/anakin/default_{system}.yaml", SPO_SMALL), 1)
    cpu = module.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 3)
    state, _ = cpu.learn.rollout(cpu.learner_state)
    return cpu, state, module.learner_setup(envs.make(cfg)[0], cfg, torch.device(device), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("system", ["ff_spo", "ff_spo_continuous"])
def test_spo_search_on_the_card_matches_the_cpu(system):
    # One SMC search of every env from the same core states, params and
    # draws (made on the CPU): the resampling decisions and the chosen
    # particles exact, the particles' root actions exact (Pendulum's floats
    # 1e-6), the weights 1e-6, the advantage sums 1e-5 relative.
    from stoix_tpu_torch.systems.search import ff_az
    from stoix_tpu_torch.systems.spo import ff_spo
    device = _require_cuda()
    cpu, state, card = _spo_setups(system, device)
    outs = []
    for setup, where in ((cpu, "cpu"), (card, device)):
        search = setup.learn.acting.search
        noise = _to(search.draw_noise(torch.Generator().manual_seed(6), 16), where)
        sim_state = ff_az.simulator_state(_to(state.env_state, where), 0, 1,
                                          torch.Generator(device=where))
        out = search(_to(state.params, where), noise, sim_state,
                     _to(state.timestep.observation, where))
        outs.append((out, ff_spo.choose(out.particle_actions, out.weights, noise.choice)[1]))
    (cpu_out, cpu_choice), (card_out, card_choice) = outs
    assert torch.equal(card_out.resampled.cpu(), cpu_out.resampled)
    assert torch.equal(card_choice.cpu(), cpu_choice)
    atol = 1e-6 if system == "ff_spo_continuous" else 0.0
    torch.testing.assert_close(card_out.particle_actions.cpu(), cpu_out.particle_actions,
                               rtol=0, atol=atol)
    torch.testing.assert_close(card_out.weights.cpu(), cpu_out.weights, rtol=0, atol=1e-6)
    torch.testing.assert_close(card_out.raw_advantages.cpu(), cpu_out.raw_advantages, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("system", ["ff_spo", "ff_spo_continuous"])
def test_spo_epoch_on_the_card_matches_the_cpu(system):
    # One epoch on a CPU-made sample from the same params: losses 1e-5
    # relative, params, targets and duals 1e-5 absolute; one launch of B1's
    # GAE entry (batch-major), nothing else.
    from stoix_tpu_torch.utils.tree import tree_leaves
    device = _require_cuda()
    cpu, state, card = _spo_setups(system, device)
    batch = cpu.learn.buffer.sample(state.buffer_state, torch.Generator().manual_seed(2))
    cpu_params, _, cpu_metrics = cpu.learn.update_from_batch(
        [state.params], [state.opt_states], [batch.experience])
    before = {c.name: c.launches for c in lr.COUNTERS}
    card_params, _, card_metrics = card.learn.update_from_batch(
        [_to(state.params, device)], [_to(state.opt_states, device)],
        [_to(batch.experience, device)])
    torch.cuda.synchronize()
    launched = {c.name: c.launches - before[c.name] for c in lr.COUNTERS}
    assert launched == {lr.KERNEL.name: 0, lr.GAE_KERNEL.name: 1}
    for key, value in cpu_metrics.items():
        torch.testing.assert_close(card_metrics[key].cpu(), value, rtol=1e-5, atol=1e-7)
    for got, want in zip(tree_leaves(card_params[0]), tree_leaves(cpu_params[0])):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["grounded", "meta"])
def test_disco_minibatch_step_on_the_card_matches_the_cpu(mode, tmp_path):
    # One minibatch step on a CPU-made rollout from the same params and
    # meta-state (meta mode: meta-params from an npz the port writes): the
    # rule's losses 1e-5 relative, params and the EMA params 1e-5 absolute,
    # no B1 launch.
    import numpy as np

    from stoix_tpu_torch import envs
    from stoix_tpu_torch.systems.disco import ff_disco103, update_rule
    from stoix_tpu_torch.utils import config as config_lib
    from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
    from stoix_tpu_torch.utils.tree import tree_leaves, tree_map
    device = _require_cuda()
    path = tmp_path / "meta.npz"
    overrides = ["network.agent_network.shared_torso.layer_sizes=[32,32]",
                 "network.agent_network.action_conditional_torso.lstm_size=16",
                 "arch.total_num_envs=32", f"system.rule_mode={mode}",
                 f"system.meta_params_path={path}"]
    cfg = check_total_timesteps(config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_disco103.yaml", overrides), 1)
    rule = ff_disco103.make_rule(cfg, 2, "cpu")
    np.savez(path, **update_rule.flatten_meta_params(rule.init_params(torch.Generator())))
    setups = [ff_disco103.learner_setup(envs.make(cfg)[0], cfg, torch.device(where), 3)
              for where in ("cpu", device)]
    state, traj = setups[0].learn.rollout(setups[0].learner_state)
    batch = tree_map(lambda x: x[:, :8], traj._replace(info=None))
    args = ([state.params], [state.opt_states], [state.meta_state], [batch])
    cpu = setups[0].learn.update_minibatch(*args)
    before = {c.name: c.launches for c in lr.COUNTERS}
    card = setups[1].learn.update_minibatch(*_to(args, device))
    torch.cuda.synchronize()
    assert all(c.launches == before[c.name] for c in lr.COUNTERS)
    for key, value in cpu[3].items():
        torch.testing.assert_close(card[3][key].cpu(), value, rtol=1e-5, atol=1e-7)
    for got, want in zip(tree_leaves((card[0], card[2])), tree_leaves((cpu[0], cpu[2]))):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_b1_gae_entry_from_spo_batch_major_sequences_matches_plain_version_bitwise():
    # ff_spo's launch: truncated GAE over [32, 32] sampled [B, L] sequences
    # (the dispatch's view, one launch), against the plain version on the
    # time-major tensors.
    device = _require_cuda()
    gen = torch.Generator(device=device).manual_seed(9)
    reward, v_tm1, v_t = (torch.randn((32, 32), generator=gen, device=device) for _ in range(3))
    done = torch.rand((32, 32), generator=gen, device=device) < 0.05
    trunc = ((torch.rand((32, 32), generator=gen, device=device) < 0.03) & ~done).float()
    discount = 0.99 * (1.0 - done.float())
    before = lr.GAE_KERNEL.launches
    got = multistep.truncated_generalized_advantage_estimation(
        reward, discount, 0.95, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc, batch_major=True,
        impl="pallas")
    torch.cuda.synchronize()
    assert lr.GAE_KERNEL.launches == before + 1
    want = lr.plain_truncated_gae(*(x.T.contiguous() for x in (reward, discount, v_tm1, v_t,
                                                                trunc)), 0.95)
    for g, w in zip(got, want):
        assert torch.equal(g.T, w)


# ---------------------------------------------------- vision (A14's first half)

def _vision_env(name):
    from stoix_tpu_torch.envs import breakout_pixel, minatar

    return {"Breakout-atari": (breakout_pixel.BreakoutPixel(), lambda s: s.serves - 1),
            "Breakout-minatar": (minatar.Breakout(), lambda s: s.ball_c == 0),
            "Asterix-minatar": (minatar.Asterix(), None),
            "Freeway-minatar": (minatar.Freeway(), None),
            "SpaceInvaders-minatar": (minatar.SpaceInvaders(), None)}[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Breakout-atari", "Breakout-minatar", "Asterix-minatar",
                                  "Freeway-minatar", "SpaceInvaders-minatar"])
def test_vision_env_on_the_card_matches_the_cpu_exactly(name):
    """40 steps from the CPU's reset draws, with no auto-reset (ended envs
    step past their end): every timestep equal."""
    device = _require_cuda()
    env, draws_of = _vision_env(name)
    cpu_state, cpu_ts = env.reset(torch.Generator().manual_seed(1), 16)
    gen = torch.Generator(device=device).manual_seed(1)
    card_state, card_ts = (env.reset(gen, 16) if draws_of is None
                           else env.reset_from_draws(draws_of(cpu_state).to(device), gen))
    actions = torch.Generator().manual_seed(2)
    for _ in range(40):
        for a, b in ((cpu_ts.step_type, card_ts.step_type), (cpu_ts.reward, card_ts.reward),
                     (cpu_ts.discount, card_ts.discount),
                     *zip(cpu_ts.observation, card_ts.observation)):
            assert torch.equal(a, b.cpu())
        action = torch.randint(0, env.num_actions, (16,), generator=actions)
        cpu_state, cpu_ts = env.step(cpu_state, action)
        card_state, card_ts = env.step(card_state, action.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cnn_atari", "visual_resnet", "mlp_resnet"])
def test_vision_torso_forward_and_gradients_on_the_card_match_the_cpu(kind):
    """The torso's output and the gradients of (out ** 2).sum() on the card
    against the CPU, TF32 off: 1e-5 relative to each tensor's scale."""
    import copy

    from stoix_tpu_torch.networks import resnet, torso

    device = _require_cuda()
    gen = torch.Generator().manual_seed(0)
    module, shape = {
        "cnn_atari": (lambda: torso.CNNTorso((84, 84, 4), (32, 64, 64), (8, 4, 3), (4, 2, 1),
                                             hidden_sizes=(512,), generator=gen), (8, 84, 84, 4)),
        "visual_resnet": (lambda: resnet.VisualResNetTorso(
            (10, 10, 4), (16, 32), (2, 2), generator=gen), (2, 8, 10, 10, 4)),
        "mlp_resnet": (lambda: resnet.MLPResNetTorso(4, generator=gen), (32, 4)),
    }[kind]
    cpu = module()
    card = copy.deepcopy(cpu).to(device)
    x = torch.rand(shape, generator=gen)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        outs = []
        for net, inp in ((cpu, x), (card, x.to(device))):
            out = net(inp)
            (out ** 2).sum().backward()
            outs.append([out.detach().cpu()] + [p.grad.cpu() for p in net.parameters()])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    for want, got in zip(*outs):
        scale = float(want.abs().max().clamp_min(1e-30))
        assert float((got - want).abs().max()) <= 1e-5 * scale


# ------------------------------------------------- grid games and locomotion


def _grid_game(name):
    """(env, draws for its reset, draws for a step or None) of a grid game,
    the draws made on the CPU."""
    from stoix_tpu_torch.envs import doorkey, game2048, snake

    gen = torch.Generator().manual_seed(9)
    if name == "Snake-v1":
        env = snake.Snake(6, 6, max_steps=30)
        return (env, lambda e: (torch.randint(0, 36, (e,), generator=gen),
                                snake.gumbel(gen, (e, 36))),
                lambda e: snake.gumbel(gen, (e, 36)))
    if name == "Game2048-v1":
        env = game2048.Game2048(max_steps=30)
        return env, lambda e: env._draws(gen, (e, 2)), lambda e: env._draws(gen, (e,))
    return doorkey.DoorKey(6, max_steps=30), lambda e: doorkey.DoorKeyDraws(
        torch.randint(2, 4, (e,), generator=gen), torch.randint(1, 5, (e,), generator=gen),
        *(snake.gumbel(gen, (e, 36)) for _ in range(3)),
        torch.randint(0, 4, (e,), generator=gen)), None


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Snake-v1", "Game2048-v1", "DoorKey-v0"])
def test_grid_game_on_the_card_matches_the_cpu_exactly(name):
    """40 steps from the same reset draws and step draws (made on the CPU),
    with no auto-reset (ended envs step past their end): every timestep,
    action masks included, equal."""
    device = _require_cuda()
    env, reset_draws, step_draws = _grid_game(name)
    draws = reset_draws(16)
    cpu_state, cpu_ts = env.reset_from_draws(draws, torch.Generator())
    card_state, card_ts = env.reset_from_draws(_to(draws, device),
                                               torch.Generator(device=device))
    actions = torch.Generator().manual_seed(2)
    for _ in range(40):
        for a, b in ((cpu_ts.step_type, card_ts.step_type), (cpu_ts.reward, card_ts.reward),
                     (cpu_ts.discount, card_ts.discount),
                     *zip(cpu_ts.observation, card_ts.observation)):
            assert torch.equal(a, b.cpu())
        action = torch.randint(0, env.num_actions, (16,), generator=actions)
        if step_draws is None:
            cpu_state, cpu_ts = env.step(cpu_state, action)
            card_state, card_ts = env.step(card_state, action.to(device))
        else:
            step = step_draws(16)
            cpu_state, cpu_ts = env.step_from_draws(cpu_state, action, step)
            card_state, card_ts = env.step_from_draws(card_state, action.to(device),
                                                      _to(step, device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Ant", "Hopper", "Walker2d", "HalfCheetah"])
def test_locomotion_control_step_on_the_card_matches_the_cpu(name):
    """From the same reset draws, 12 control steps, each from the CPU's state
    under the same random actions: step types, discounts and truncations
    exact; rewards 1e-5 relative (floor 1e-6 of their scale); bodies and
    observations 1e-5 relative with a floor of 1e-5 of the field's scale
    (tests/test_torch_locomotion.py's bar against JAX)."""
    from stoix_tpu_torch.envs import locomotion
    device = _require_cuda()
    env = getattr(locomotion, name)(max_steps=8)
    cpu_state, _ = env.reset(torch.Generator().manual_seed(4), 16)
    gen = torch.Generator().manual_seed(5)

    def close(got, want, floor):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                   atol=floor * float(want.abs().max()))

    for _ in range(12):
        action = torch.rand((16, env._nj), generator=gen) * 2 - 1
        card_state = cpu_state._replace(generator=torch.Generator(device=device),
                                        body=_to(cpu_state.body, device),
                                        step_count=cpu_state.step_count.to(device))
        cpu_state, cpu_ts = env.step(cpu_state, action)
        card_state, card_ts = env.step(card_state, action.to(device))
        for a, b in ((cpu_ts.step_type, card_ts.step_type), (cpu_ts.discount, card_ts.discount),
                     (cpu_ts.extras["truncation"], card_ts.extras["truncation"])):
            assert torch.equal(a, b.cpu())
        close(card_ts.reward, cpu_ts.reward, 1e-6)
        close(card_ts.observation.agent_view, cpu_ts.observation.agent_view, 1e-5)
        for want, got in zip(cpu_state.body, card_state.body):
            close(got, want, 1e-5)


@pytest.mark.cuda
def test_rigid_body_accumulation_and_fma_on_the_card_are_the_cpus_bitwise():
    """The contributions' rounds on the card, twice, bitwise equal to each
    other and to the CPU's (the same adds in the same order); the engine's
    fused multiply-add bitwise `fma_f32`."""
    from stoix_tpu_torch.envs import locomotion, rigid_body
    device = _require_cuda()
    sys = locomotion.Ant()._sys
    gen = torch.Generator().manual_seed(0)
    values = torch.randn((1024, 16, 6), generator=gen) * 10.0 ** torch.randint(
        -4, 8, (1024, 16, 6), generator=gen)
    want = rigid_body.accumulate(values, sys.joint_rounds)
    rounds = sys.joint_rounds.to(device)
    first = rigid_body.accumulate(values.to(device), rounds)
    second = rigid_body.accumulate(values.to(device), rounds)
    assert torch.equal(first, second) and torch.equal(first.cpu(), want)
    a, b, c = (torch.randn(100003, generator=gen) for _ in range(3))
    got = rigid_body.fused_multiply_add(a.to(device), b.to(device), c.to(device))
    assert torch.equal(got.cpu(), lr.fma_f32(a, b, c))


LOCO_GRID_PPO = {
    # case: (system, overrides)
    "ant": ("ff_ppo_continuous", ["env=ant", "system.normalize_observations=true",
                                  "env.kwargs.max_steps=6"]),
    "snake": ("ff_ppo", ["env=snake"]),
    "game_2048": ("ff_ppo", ["env=game_2048"]),
    "doorkey": ("ff_ppo", ["env=doorkey"]),
}


def _loco_grid_ppo_update(case, device, card_state=None, traj=None):
    """The learner setup of the case on `device` (16 envs, T = 8, 2 x 2
    minibatches, multistep_impl=pallas) and, given the card's state and
    rollout, one update of it on `device` with fixed permutations."""
    import importlib

    from stoix_tpu_torch import envs
    from stoix_tpu_torch.utils import config as config_lib
    from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
    system, overrides = LOCO_GRID_PPO[case]
    module = importlib.import_module(f"stoix_tpu_torch.systems.ppo.anakin.{system}")
    cfg = check_total_timesteps(config_lib.compose(
        config_lib.default_config_dir(), f"default/anakin/default_{system}.yaml",
        overrides + ["arch.total_num_envs=16", "system.rollout_length=8", "system.epochs=2",
                     "system.num_minibatches=2", "system.multistep_impl=pallas",
                     "logger.use_console=False"]), 1)
    setup = module.learner_setup(envs.make(cfg)[0], cfg, torch.device(device), 3)
    if card_state is None:
        return setup
    perms = [torch.randperm(128, generator=torch.Generator().manual_seed(e)).to(device)
             for e in range(2)]
    state = _to(card_state, device)
    return setup.learn.update(state.params, state.opt_states, _to(traj, device),
                              permutations=perms)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LOCO_GRID_PPO))
def test_loco_grid_ppo_update_on_the_card_matches_the_cpu(case):
    """A rollout on the card, then one update of it on the card and on the
    CPU from the card's params: exactly one B1 GAE launch on the card;
    targets 1e-5 of their scale (the critic's 256-wide float32 sums part
    card and CPU by about 1e-6 of it: DoorKey's by 5.96e-7 of 0.44); the
    standardised advantages 1e-5 of the targets' scale carried through the
    standardisation (max |targets| over the raw advantages' std: DoorKey's
    near-constant rewards make that std small, and its card and CPU
    advantages part by 4.4e-6, 1e-6 of its targets' scale times that gain
    of 4.4); losses 1e-5 relative, params 1e-5 absolute."""
    device = _require_cuda()
    from stoix_tpu_torch.utils.tree import tree_map
    card = _loco_grid_ppo_update(case, device)
    state, traj = card.learn.rollout(card.learner_state)
    host_state = state._replace(
        params=tree_map(lambda x: x.cpu(), state.params),
        opt_states=tree_map(lambda x: x.cpu(), state.opt_states))
    cpu = _loco_grid_ppo_update(case, "cpu", host_state, tree_map(lambda x: x.cpu(), traj))
    before = lr.GAE_KERNEL.launches
    on_card = _loco_grid_ppo_update(case, device, state, traj)
    torch.cuda.synchronize()
    assert lr.GAE_KERNEL.launches == before + 1
    scale = float(cpu.targets.abs().max())
    gain = scale / float((cpu.targets - traj.value.cpu()).std())
    torch.testing.assert_close(on_card.targets.cpu(), cpu.targets, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(on_card.advantages.cpu(), cpu.advantages, rtol=0,
                               atol=1e-5 * gain)
    for key, value in cpu.loss_info.items():
        torch.testing.assert_close(on_card.loss_info[key].cpu(), value, rtol=1e-5, atol=1e-7)
    for side in (0, 1):
        for k, v in cpu.params[side].items():
            torch.testing.assert_close(on_card.params[side][k].cpu(), v, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_sac_update_on_ant_on_the_card_matches_the_cpu():
    """ff_sac's update_from_batch on an Ant-shaped batch (27-dim
    observations, 8 actions) with the same noise: no kernel launch; losses
    1e-5 relative, params 1e-5 absolute."""
    from stoix_tpu_torch.base_types import Transition
    from stoix_tpu_torch.envs.types import Observation
    from stoix_tpu_torch.systems import anakin
    from stoix_tpu_torch.utils.tree import tree_leaves
    device = _require_cuda()
    gen = torch.Generator().manual_seed(6)

    def obs():
        return Observation(torch.randn((64, 27), generator=gen), torch.ones((64, 8)),
                           torch.zeros((64,), dtype=torch.int32))

    batch = Transition(obs(), torch.rand((64, 8), generator=gen) * 2 - 1,
                       torch.randn(64, generator=gen), torch.rand(64, generator=gen) < 0.1,
                       obs(), {})
    results = []
    for dev in ("cpu", device):
        setup, state = _a12_setup("ff_sac", dev, ["env=ant", "env.kwargs.max_steps=8"])
        update = setup.learn.update_from_batch
        params = anakin.split_replicas(state.params, 1)
        opts = anakin.split_replicas(state.opt_states, 1)
        noise = update.draw_noise(batch, torch.Generator().manual_seed(5))
        before = {c.name: c.launches for c in lr.COUNTERS}
        params, _, metrics = update.step(params, opts, [_to(batch, dev)], [_to(noise, dev)])
        assert {c.name: c.launches - before[c.name] for c in lr.COUNTERS} == {
            c.name: 0 for c in lr.COUNTERS}
        results.append((params[0], metrics))
    (cpu_params, cpu_metrics), (card_params, card_metrics) = results
    for key, value in cpu_metrics.items():
        torch.testing.assert_close(card_metrics[key].cpu(), value, rtol=1e-5, atol=1e-7)
    for card, cpu in zip(tree_leaves(card_params), tree_leaves(cpu_params)):
        torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name,overrides", [
    ("ff_dqn", []), ("ff_c51", []),
    ("ff_dqn", ["network=cnn_dqn", "env.wrapper.flatten_observation=false"])])
def test_q_update_on_snake_on_the_card_matches_the_cpu(name, overrides):
    """Two update_from_batch steps of the Q network the config builds for
    Snake, on a batch of masked Snake observations, TF32 off (cnn_dqn's
    convolutions): loss 1e-5 relative, online and target params 1e-5
    absolute; no kernel launch."""
    from stoix_tpu_torch import envs
    from stoix_tpu_torch.base_types import OnlineAndTarget, Transition
    from stoix_tpu_torch.envs.types import Observation
    from stoix_tpu_torch.systems.q_learning import ff_c51, ff_dqn, q_family
    from stoix_tpu_torch.utils import config as config_lib
    from stoix_tpu_torch.utils.training import ClipAdam
    device = _require_cuda()
    cfg = config_lib.compose(config_lib.default_config_dir(), f"default/anakin/default_{name}.yaml",
                             ["env=snake"] + overrides)
    env = envs.make(cfg)[0]
    loss_fn = ff_dqn.dqn_loss if name == "ff_dqn" else ff_c51.c51_loss
    shape = tuple(env.observation_space().agent_view.shape)
    gen = torch.Generator().manual_seed(3)

    def obs():
        mask = (torch.rand((64, 4), generator=gen) > 0.25).float()
        mask[:, 0] = 1.0
        return Observation((torch.rand((64,) + shape, generator=gen) > 0.8).float(), mask,
                           torch.zeros((64,), dtype=torch.int32))

    batch = Transition(obs(), torch.randint(0, 4, (64,), generator=gen),
                       torch.randn(64, generator=gen), torch.rand(64, generator=gen) < 0.2,
                       obs(), {})
    results = []
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", device):
            net = q_family.build_q_network(env, cfg, torch.Generator().manual_seed(0)).to(dev)
            online = {k: v.detach() for k, v in net.named_parameters()}
            target = {k: v * 0.5 for k, v in online.items()}
            optim = ClipAdam(1e-3, 0.5, eps=1e-5)
            update = q_family.QUpdate(loss_fn, q_family.make_q_apply(net), optim, cfg)
            params, opt = [OnlineAndTarget(online, target)], [optim.init(online)]
            before = {c.name: c.launches for c in lr.COUNTERS}
            for _ in range(2):
                params, opt, info = update(params, opt, [_to(batch, dev)])
            assert all(c.launches == before[c.name] for c in lr.COUNTERS)
            results.append((params[0], info["q_loss"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    (cpu_params, cpu_loss), (card_params, card_loss) = results
    torch.testing.assert_close(card_loss.cpu(), cpu_loss, rtol=1e-5, atol=0)
    for side in (0, 1):
        for k, v in cpu_params[side].items():
            torch.testing.assert_close(card_params[side][k].cpu(), v, rtol=0, atol=1e-5)


# ----------------------------------------------------------------- Sebulba's off-policy half


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
def test_replay_service_on_the_card_matches_the_cpu(shards):
    """The sharded service (prioritized) on the card against the same one on
    the CPU: adds, `set_priorities` with duplicate indices across shards,
    then one draw from the same uniforms; indices and rows exact,
    probabilities and priorities 1e-6 relative."""
    from stoix_tpu_torch.replay import ShardedReplayService

    device = _require_cuda()
    gen = torch.Generator().manual_seed(0)
    item = {"obs": torch.zeros(64), "action": torch.zeros((), dtype=torch.int32),
            "done": torch.zeros((), dtype=torch.bool)}
    services = [ShardedReplayService([dev] * shards, {k: v.to(dev) for k, v in item.items()},
                                     capacity_per_shard=512, sample_batch_size=256,
                                     prioritized=True) for dev in ("cpu", device)]
    for _ in range(3):  # 3 x 400 items a shard through 512 slots: the rings wrap
        chunk = [{"obs": torch.randn((400, 64), generator=gen),
                  "action": torch.randint(0, 4, (400,), generator=gen, dtype=torch.int32),
                  "done": torch.rand((400,), generator=gen) < 0.1} for _ in range(shards)]
        for svc in services:
            svc.add([{k: v.to(svc.devices[0]) for k, v in c.items()} for c in chunk])
    idx = torch.randint(0, 512 * shards, (256,), generator=gen, dtype=torch.int32)
    values = torch.rand((256,), generator=gen) * 4.0
    for svc in services:
        dev = svc.devices[0]
        svc.set_priorities(list(idx.to(dev).chunk(shards)), list(values.to(dev).chunk(shards)))
    uniforms = torch.rand((256,), generator=gen)
    want, got = (svc.sample(uniforms=uniforms.to(svc.devices[0])) for svc in services)
    for w, g in zip(want, got):
        assert torch.equal(g.indices.cpu(), w.indices)
        for k in item:
            assert torch.equal(g.experience[k].cpu(), w.experience[k])
        torch.testing.assert_close(g.probabilities.cpu(), w.probabilities, rtol=1e-6, atol=0)
    for w, g in zip(services[0].state, services[1].state):
        torch.testing.assert_close(g.priorities.cpu(), w.priorities, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["uniform", "prioritized"])
def test_sebulba_dqn_learn_step_on_the_card_matches_the_cpu(mode):
    """chip_smoke.py's sebulba_offpolicy_parity case: one ff_dqn learn step
    at the default config from the same ring, params and uniforms (losses
    1e-5 relative, params 1e-5 absolute, priorities 1e-6); no kernel
    launch."""
    import chip_smoke

    _require_cuda()
    before = {c.name: c.launches for c in lr.COUNTERS}
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        chip_smoke._dqn_step_on_card_and_cpu(mode)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert all(c.launches == before[c.name] for c in lr.COUNTERS)


@pytest.mark.cuda
def test_impact_learn_step_on_the_card_matches_the_cpu():
    """chip_smoke.py's IMPACT case: one learn step at [64, 512] through one
    B1 GAE launch, against the CPU (losses 1e-5 relative, params 1e-5
    absolute), B1 bitwise against its plain version on its inputs."""
    import chip_smoke

    _require_cuda()
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        result = chip_smoke._impact_step_on_card_and_cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert result["b1_gae_bitwise"] and result["kernel_launches"][lr.GAE_KERNEL.name] == 1


# C27 on the card: a one-rank NCCL ring's output and gradients against float64
# full attention on the host (1e-5 of each gradient's largest entry, 2e-5 the
# output, as tests/test_torch_ring_grad.py); use_flash=True under grad refused.
@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_ring_backward_on_the_card_matches_the_cpu(tmp_path, causal):
    device = _require_cuda()
    config = Config.from_dict({"arch": {"distributed": {
        "coordinator_address": f"file://{tmp_path / 'store'}", "num_processes": 1,
        "process_id": 0}}})
    gen = torch.Generator(device=device).manual_seed(5)
    q, k, v, w = (torch.randn((4, 64, 2, 16), generator=gen, device=device) for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    parallel.maybe_initialize_distributed(config, device="cuda")
    try:
        group = parallel.create_mesh({"data": 1}, device="cuda").get_group("data")
        before = fac.KERNEL.launches
        out = ring_attention(*leaves, group, causal=causal)
        (out * w).sum().backward()
        assert fac.KERNEL.launches == before  # the plain ring: B3 has no backward
        with pytest.raises(NotImplementedError, match="C5"):
            ring_attention(*leaves, group, causal=causal, use_flash=True)
    finally:
        dist.destroy_process_group()
    ref = [x.detach().cpu().double().requires_grad_(True) for x in (q, k, v)]
    want = full_attention(*ref, causal=causal)
    (want * w.cpu().double()).sum().backward()
    torch.testing.assert_close(out.detach().cpu().double(), want.detach(), rtol=0, atol=2e-5)
    for got, r in zip(leaves, ref):
        assert float((got.grad.cpu().double() - r.grad).abs().max()) <= 1e-5 * float(
            r.grad.abs().max())


# A gossip mixing round on the card: one torch.addcmul a term (nvcc's fmaf)
# against the CPU's fma_f32, bitwise, for every topology.
@pytest.mark.cuda
@pytest.mark.parametrize("topology", ["ring", "all_pairs", "random_peer"])
def test_mixing_round_on_the_card_matches_the_cpu(topology):
    from stoix_tpu_torch.parallel import gossip

    device = _require_cuda()
    settings = gossip.GossipSettings(True, 1, topology, 0.3, False, 7)
    shift = gossip.random_peer_shift(7, 2, 3) if topology == "random_peer" else None
    matrix = gossip.mixing_matrix(settings, 3, shift)
    leaf = torch.randn((3, 257, 33), generator=torch.Generator().manual_seed(1)) * 3
    got = gossip._mix_leaf(matrix, leaf.to(device))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), gossip._mix_leaf(matrix, leaf))


class _LivesPool:
    """A pool with envpool's surface (tests/test_envpool_adapter.py's
    FakeEnvPool, vectorised): the step after a done resets, 2 lives, a life
    ends every 3 steps except env 3's, which is cut at 6 elapsed steps."""

    class spec:
        class config:
            max_episode_steps = 6

    class action_space:
        n = 5

    def __init__(self, num_envs: int):
        self._n = num_envs
        self._game = torch.zeros(num_envs, dtype=torch.int64)
        self._step = torch.zeros(num_envs, dtype=torch.int64)
        self._lives = torch.full((num_envs,), 2, dtype=torch.int64)
        self._reset = torch.zeros(num_envs, dtype=torch.bool)

    def _obs(self, ids):
        return (10 * ids + self._game[ids]).float()[:, None].repeat(1, 2).numpy()

    def reset(self):
        self.__init__(self._n)
        return self._obs(torch.arange(self._n)), {}

    def step(self, action, env_ids=None):
        import numpy as np

        ids = torch.arange(self._n) if env_ids is None else torch.as_tensor(env_ids)
        resetting = self._reset[ids]
        over = ids[resetting & (self._lives[ids] <= 0)]
        self._lives[over] = 2
        self._game[over] += 1
        self._step[ids[resetting]] = 0
        self._reset[ids[resetting]] = False
        moving = ids[~resetting]
        self._step[moving] += 1
        dies = ~resetting & (self._step[ids] >= 3) & (ids != 3)
        self._lives[ids[dies]] -= 1
        self._reset[ids[dies]] = True
        self._reset[ids[~dies & ~resetting & (self._step[ids] >= 6)]] = True
        reward = (~resetting).float().numpy()
        info = {"elapsed_step": self._step[ids].numpy().copy(),
                "lives": self._lives[ids].numpy().copy(), "reward": reward.copy()}
        return self._obs(ids), reward, dies.numpy(), np.zeros(len(ids), bool), info

    def close(self):
        pass


def _stateful_returns(factory, device, num_actions):
    from stoix_tpu_torch.evaluator import get_stateful_evaluator_fn

    devices = set()

    def act(params, observation, generator):
        devices.add(observation.agent_view.device.type)
        return (observation.agent_view[:, 0].to(torch.int64) + params) % num_actions

    config = Config.from_dict({"arch": {"num_eval_episodes": 8}})
    evaluate = get_stateful_evaluator_fn(factory, act, config, device)
    returns = evaluate(torch.tensor(1, device=device),
                       torch.Generator(device=device))["episode_return"]
    assert devices == {torch.device(device).type}
    return returns


# The stateful evaluator acting on the card: the same returns as on the CPU
# over an envpool-adapted pool, and over gymnasium CartPole-v1 where
# gymnasium is installed.
@pytest.mark.cuda
def test_stateful_evaluator_on_the_card_matches_the_cpu():
    from stoix_tpu_torch.envs.envpool_adapter import EnvPoolAdapter

    device = _require_cuda()
    factory = lambda n: EnvPoolAdapter(_LivesPool(n), has_lives=True)  # noqa: E731
    card = _stateful_returns(factory, device, 5)
    cpu = _stateful_returns(factory, "cpu", 5)
    assert card.shape == (8,) and torch.equal(card, cpu)


@pytest.mark.cuda
def test_stateful_evaluator_on_gymnasium_on_the_card_matches_the_cpu():
    device = _require_cuda()
    pytest.importorskip("gymnasium")
    from stoix_tpu_torch.envs.gymnasium_adapter import GymnasiumFactory

    def factory(num_envs):
        # The evaluator resets without a seed: seed the pool's streams first.
        envs = GymnasiumFactory("CartPole-v1", 3)(num_envs)
        envs.reset(seed=3)
        return envs

    card = _stateful_returns(factory, device, 2)
    cpu = _stateful_returns(factory, "cpu", 2)
    assert card.shape == (8,) and torch.equal(card, cpu)


# The operations layer on the card (A19a): integer fingerprints do not
# depend on the order of their sums, so the card's equal the CPU's; the
# probe child reports the card; the poller reads the allocator; the memory
# gate refuses a run past a faked small limit.
@pytest.mark.cuda
def test_fingerprint_of_card_tensors_equals_the_cpus_bitwise():
    from stoix_tpu_torch.resilience import integrity

    device = _require_cuda()
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(257, 129, generator=gen), torch.randn(31, generator=gen).bfloat16(),
              torch.randint(-9, 9, (1000,), generator=gen, dtype=torch.int32),
              torch.rand(77, generator=gen) > 0.5, torch.zeros(0)]
    assert integrity.fingerprint_leaves([x.to(device) for x in leaves], 5) == (
        integrity.fingerprint_leaves(leaves, 5))
    state = {"params": {"w": leaves[0]}, "opt_states": (leaves[2], leaves[1])}
    card_state = {"params": {"w": leaves[0].to(device)},
                  "opt_states": (leaves[2].to(device), leaves[1].to(device))}
    assert integrity.Fingerprinter(card_state)(card_state) == integrity.Fingerprinter(state)(state)


@pytest.mark.cuda
def test_probe_child_reports_the_card():
    from stoix_tpu_torch.resilience import preflight

    _require_cuda()
    probe = preflight.probe_backend(timeout_s=300.0, attempts=1)
    assert probe.platform == "cuda" and probe.device_kind == torch.cuda.get_device_name(0)
    assert probe.device_count == torch.cuda.device_count()
    assert probe.hbm_bytes_limit == torch.cuda.mem_get_info(0)[1]


@pytest.mark.cuda
def test_poller_reads_the_allocator():
    from stoix_tpu_torch.observability import introspect, registry

    device = _require_cuda()
    held = torch.empty(1 << 20, device=device)
    reg = registry.MetricsRegistry()
    assert introspect.sample_device_telemetry(reg) >= 4
    gauge = reg.gauge("stoix_tpu_device_memory_bytes")
    labels = {"device": "cuda:0", "kind": "bytes_in_use", "source": "memory_stats"}
    assert gauge.value(labels) >= held.numel() * 4
    assert gauge.value({"device": "cuda:0", "kind": "bytes_limit",
                        "source": "mem_get_info"}) == torch.cuda.mem_get_info(0)[1]


@pytest.mark.cuda
def test_memory_gate_rejects_a_faked_small_limit():
    from stoix_tpu_torch.resilience import preflight
    from stoix_tpu_torch.resilience.errors import ResourcePreflightError

    device = _require_cuda()
    estimate = {"predicted_bytes": 1 << 30, "state_bytes": 1 << 29, "rollout_bytes": 1 << 29}
    gated = preflight.check_device_memory(estimate, device)
    assert gated["limit_bytes"] == torch.cuda.mem_get_info(0)[1]
    with pytest.raises(ResourcePreflightError, match="exceeds 90%"):
        preflight.check_device_memory(estimate, device, limit_bytes=1 << 30)
    # The measured half on a real peak: it fits the card and not a faked
    # limit below it.
    held = torch.empty(1 << 24, device=device)
    peak = torch.cuda.max_memory_reserved(device)
    assert peak >= held.numel() * 4
    preflight.check_window_peak(gated, peak)
    with pytest.raises(ResourcePreflightError, match="measured"):
        preflight.check_window_peak({**gated, "limit_bytes": peak}, peak)


@pytest.mark.cuda
def test_sebulba_determinism_probe_is_clean_on_the_card(tmp_path, monkeypatch):
    """Sebulba ff_ppo's integrity check, the replay of update 0, on the card:
    the learn step is repeatable there, so a healthy run reaches no verdict."""
    from stoix_tpu_torch.systems.ppo.sebulba import ff_ppo as sebulba_ppo
    from stoix_tpu_torch.utils import config as config_lib

    _require_cuda()
    monkeypatch.chdir(tmp_path)
    cfg = config_lib.compose(config_lib.default_config_dir(), "default/sebulba/default_ff_ppo.yaml", [
        "env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=4096",
        "arch.num_evaluation=2", "arch.num_eval_episodes=8", "system.rollout_length=8",
        "logger.use_console=False", "arch.actor.device_ids=[0]", "arch.learner.device_ids=[0]",
        "arch.evaluator_device_id=0", "arch.integrity.enabled=true",
        "arch.integrity.determinism_probe_interval=1", f"logger.base_exp_path={tmp_path}"])
    sebulba_ppo.run_experiment(cfg, device="cuda")
    assert sebulba_ppo.LAST_RUN_STATS["integrity"]["probe_runs"] == 2


def _population_update(device):
    """One update of each member of a population of 2 with ent_coef,
    gae_lambda and actor_lr lifted, through the population learner's member
    learners, on explicit [8, 16] trajectories with given permutations, under
    multistep_impl pallas on the card and scan on the CPU."""
    from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams, PPOTransition
    from stoix_tpu_torch.networks import base, heads, inputs, torso
    from stoix_tpu_torch.population import hparams as hparams_lib
    from stoix_tpu_torch.population import runner as prun
    from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
    from stoix_tpu_torch.utils import config as config_lib
    impl = "pallas" if torch.device(device).type == "cuda" else "scan"
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             "default/population/default_ff_ppo.yaml",
                             ["system.epochs=2", "system.num_minibatches=2",
                              "arch.num_updates_per_eval=1", f"system.multistep_impl={impl}",
                              "arch.population.size=2"])
    config_lib._set_dotted(cfg, "arch.population.hparams", {
        "system.ent_coef": [0.01, 0.05], "system.gae_lambda": [0.95, 0.8],
        "system.actor_lr": [1e-3, 3e-3]})
    _, arrays = hparams_lib.lift_hparams(cfg)
    results = []
    for p in range(2):
        gen = torch.Generator().manual_seed(20 + p)
        actor = base.FeedForwardActor(heads.CategoricalHead(3, 16, generator=gen),
                                      torso.MLPTorso(5, (16, 16), generator=gen),
                                      inputs.ObservationInput()).to(device)
        critic = base.FeedForwardCritic(heads.ScalarCriticHead(16, generator=gen),
                                        torso.MLPTorso(5, (16, 16), generator=gen),
                                        inputs.ObservationInput()).to(device)
        apply = (ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic))
        learner = prun.PopulationLearner(None, apply, ff_ppo.make_optimizers(cfg), cfg, None)
        state = prun.PopulationState(None, {k: torch.from_numpy(v) for k, v in arrays.items()},
                                     torch.zeros(2), 0, None, 0)
        member = learner.member_learner(learner.member_hparams(state)[p])
        done = torch.rand((8, 16), generator=gen) < 0.1
        obs = _observations((8, 16), 30 + p)
        action = torch.randint(0, 3, (8, 16), generator=gen)
        with torch.no_grad():
            log_prob = apply[0]({k: v for k, v in actor.named_parameters()},
                                _to(obs, device)).log_prob(action.to(device)).cpu()
        traj = PPOTransition(done, (torch.rand((8, 16), generator=gen) < 0.1) & ~done, action,
                             torch.randn((8, 16), generator=gen),
                             torch.randn((8, 16), generator=gen), log_prob, obs,
                             _observations((8, 16), 40 + p), {})
        params = ActorCriticParams({k: v.detach() for k, v in actor.named_parameters()},
                                   {k: v.detach() for k, v in critic.named_parameters()})
        opt = ActorCriticOptStates(member.actor_optim.init(params.actor_params),
                                   member.critic_optim.init(params.critic_params))
        perms = [torch.randperm(128, generator=gen) for _ in range(2)]
        results.append(member.update(params, opt, _to(traj, device), permutations=perms))
    return results


@pytest.mark.cuda
def test_population_update_on_the_card_matches_the_cpu(monkeypatch):
    # A population update is one B1 GAE launch a member, each bitwise its
    # plain version on the same inputs; the whole update holds the CPU's
    # `scan` run at the ff_ppo card tests' tolerances.
    device = _require_cuda()
    cpu = _population_update("cpu")
    calls = []
    launch = lr.truncated_gae

    def recorded(*args):
        out = launch(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(lr, "truncated_gae", recorded)
    before = (lr.KERNEL.launches, lr.GAE_KERNEL.launches)
    card = _population_update(device)
    assert (lr.KERNEL.launches, lr.GAE_KERNEL.launches) == (before[0], before[1] + 2)
    assert [args[-1] for args, _ in calls] == [0.949999988079071, 0.800000011920929]
    for args, out in calls:
        want = lr.plain_truncated_gae(*(a.cpu() if isinstance(a, torch.Tensor) else a
                                        for a in args))
        for got, expected in zip(out, want):
            assert torch.equal(got.cpu(), expected)
    for card_member, cpu_member in zip(card, cpu):
        _assert_update_matches(card_member, cpu_member)
