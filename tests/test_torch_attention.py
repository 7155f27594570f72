"""Kernel B2 (flash attention) and attention dispatch of the PyTorch port against
the JAX package, on the CPU.

- The plain forward (kernels/flash_attention.py, the CUDA kernel's arithmetic,
  folding 64-key tiles) against stoix_tpu/ops/pallas_attention.py::
  flash_attention in interpret mode, on every case of tests/
  test_pallas_attention.py, the ff_trans_ppo path's S=16, H=4, D=32 causal and
  S=200 (four 64-key tiles, the last ragged): 2e-5 (that test's own
  tolerance; both fold the online softmax, over other tile sizes), bf16 2e-2.
- The wrappers' 16-byte row alignment check, on the CPU.
- `full_attention` against the JAX package's: 1e-6 (the same ops; the
  reductions sum in another order).
- The plain backward, through the autograd function, against `jax.grad` of
  the JAX package's `full_attention` (what that package differentiates; its
  flash kernel has no VJP): 1e-5 absolute, the reductions sum in another order.
  S = 130 spans three of the backward kernel's 64-key tiles.
- The plain backward against the two-kernel composition it replaced: bitwise.
- The padded route for head dims the kernels are not built for (zero-padded
  to the next built one) against the Pallas kernel and jax.grad, and the
  float16 plain forward against the Pallas kernel.
- The wide route past head dim 256 (kernels/flash_attention_wide.py): its
  plain forward against the Pallas kernel (2e-5) and its plain backward
  against jax.grad of `full_attention` (5e-6 of the largest gradient), on
  both sides of its 512-column slice boundary; the partial sums its scores
  are taken in (`sliced_products`), bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.ops.pallas_attention import flash_attention as jax_flash_attention
from stoix_tpu.ops.ring_attention import full_attention as jax_full_attention
from stoix_tpu_torch.kernels import flash_attention as fa
from stoix_tpu_torch.kernels import flash_attention_chunk as fac
from stoix_tpu_torch.kernels import flash_attention_wide as wide
from stoix_tpu_torch.kernels.attention_common import plain_exp, sliced_products
from stoix_tpu_torch.ops import best_attention, flash_attention
from stoix_tpu_torch.ops.ring_attention import full_attention
from torch_parity import host_threads, n, t


def _qkv(seed, b, s, h, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, d)).astype(np.float32).astype(dtype)
                 for _ in range(3))


def _jax_flash(q, k, v, causal, **blocks):
    return np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal, interpret=True, **blocks))


# (batch, seq, heads, head_dim, causal, JAX kernel block sizes), after
# tests/test_pallas_attention.py: full-block sequences, padded sequences,
# several causal query blocks, and the ff_trans_ppo path's shape.
FORWARD_CASES = [
    (2, 128, 2, 64, False, dict(block_q=128, block_k=128)),
    (2, 128, 2, 64, True, dict(block_q=128, block_k=128)),
    (2, 256, 2, 64, False, dict(block_q=128, block_k=128)),
    (2, 256, 2, 64, True, dict(block_q=128, block_k=128)),
    (1, 100, 2, 32, False, dict(block_q=64, block_k=64)),
    (1, 100, 2, 32, True, dict(block_q=64, block_k=64)),
    (1, 256, 1, 32, True, dict(block_q=64, block_k=128)),
    (8, 16, 4, 32, True, {}),
    # Four of the plain forward's 64-key tiles, the last one ragged.
    (1, 200, 2, 32, True, dict(block_q=64, block_k=64)),
]


@pytest.mark.parametrize("b,s,h,d,causal,blocks", FORWARD_CASES)
def test_plain_forward_matches_the_pallas_kernel(b, s, h, d, causal, blocks):
    q, k, v = _qkv(s + h, b, s, h, d)
    got, lse = fa.plain_flash_attention_forward(t(q), t(k), t(v), causal, need_lse=True)
    want = _jax_flash(q, k, v, causal, **blocks)
    np.testing.assert_allclose(n(got), want, atol=2e-5, rtol=2e-5)
    # lse is the log-sum-exp of the scaled, masked scores.
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5
    if causal:
        scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    np.testing.assert_allclose(n(lse), np.asarray(jax.nn.logsumexp(scores, axis=-1)),
                               atol=2e-5, rtol=0)


def test_plain_forward_bf16_matches_the_pallas_kernel():
    q, k, v = _qkv(2, 1, 128, 1, 64, dtype=jnp.bfloat16)
    got, _ = fa.plain_flash_attention_forward(t(q), t(k), t(v), causal=True)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(n(got), np.asarray(want.astype(jnp.float32)), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [16, 100])
def test_full_attention_matches_jax(causal, s):
    q, k, v = _qkv(s, 2, s, 2, 32)
    got = full_attention(t(q), t(k), t(v), causal=causal)
    want = jax_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,d", [
    pytest.param(16, 32, id="16"), pytest.param(100, 32, id="100"),
    pytest.param(1, 32, id="1"), pytest.param(20, 32, id="20"), pytest.param(130, 32, id="130"),
    pytest.param(20, 16, id="20-d16"), pytest.param(130, 64, id="130-d64"),
])
def test_plain_backward_matches_jax_grad_of_full_attention(causal, s, d):
    b, h = 2, 2
    q, k, v = _qkv(40 + s, b, s, h, d)
    weight = np.random.default_rng(s).normal(size=(b, s, h, d)).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jax_full_attention(q, k, v, causal=causal) * weight)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    (out * t(weight)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(n(leaf.grad), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_the_two_kernel_composition(causal):
    # The backward before it was fused, computed inline: dQ and delta first,
    # then dK and dV from that delta, P and dS formed once in each half. The
    # fused order forms them once for all three products with the same ops on
    # the same operands, so the results agree bitwise.
    q, k, v = (t(x) for x in _qkv(5, 2, 20, 2, 16))
    dout = t(np.random.default_rng(6).normal(size=(2, 20, 2, 16)).astype(np.float32))
    o, lse = fa.plain_flash_attention_forward(q, k, v, causal, need_lse=True)
    scale = 16**-0.5
    qs, kf, vf, dof, of = (x.permute(0, 2, 1, 3) for x in (q * scale, k, v, dout, o))
    mask = torch.ones(20, 20, dtype=torch.bool)
    if causal:
        mask = mask.tril()

    def probabilities():
        return torch.where(mask, torch.exp(qs @ kf.transpose(-1, -2) - lse[..., None]), 0.0)

    delta = (dof * of).sum(-1)
    ds = probabilities() * (dof @ vf.transpose(-1, -2) - delta[..., None])
    dq = (ds @ kf) * scale
    p = probabilities()
    dv = p.transpose(-1, -2) @ dof
    dk = (p * (dof @ vf.transpose(-1, -2) - delta[..., None])).transpose(-1, -2) @ qs
    got = fa.plain_flash_attention_backward(q, k, v, o, lse, dout, causal)
    for g, want in zip(got, (dq, dk, dv)):
        assert g.is_contiguous() and g.shape == q.shape
        assert torch.equal(g, want.permute(0, 2, 1, 3))


def test_strided_qkv_views_give_the_same_result():
    rng = np.random.default_rng(7)
    proj = t(rng.normal(size=(3, 16, 3, 2, 16)).astype(np.float32))
    q, k, v = proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert torch.equal(got, want) and got.is_contiguous()


@pytest.mark.parametrize("shape", [(32, 16, 4, 32), (4, 40, 2, 384)])
def test_cpu_float32_route_matches_a_float64_reference(shape):
    # The float32 route on CPU tensors (the plain versions: narrow, and wide
    # past head dim 256) against causal softmax attention in float64, 1e-5,
    # twice and bitwise the same. A host that rounds this wrongly now and then
    # (ROADMAP.md Queue C, C9; scripts/torch_cpu_attention_probe.py) fails it.
    # The fault goes with the thread count (C11), so this test keeps the
    # host's default rather than the suite's one-thread pin.
    q, k, v = (t(x) for x in _qkv(11, *shape))
    qd, kd, vd = (x.double().permute(0, 2, 1, 3) for x in (q, k, v))
    scores = (qd @ kd.transpose(-1, -2)) * shape[3] ** -0.5
    scores = scores.masked_fill(~torch.ones(shape[1], shape[1], dtype=torch.bool).tril(),
                                float("-inf"))
    want = (scores.softmax(-1) @ vd).permute(0, 2, 1, 3)
    with host_threads():
        got = flash_attention(q, k, v, causal=True)
        assert torch.equal(got, flash_attention(q, k, v, causal=True))
    np.testing.assert_allclose(n(got).astype(np.float64), want.numpy(), atol=1e-5, rtol=0)


def test_plain_exp_is_torch_exp_on_one_thread_and_keeps_the_thread_count():
    # C11's repair: every plain attention's exp on one intra-op thread on the
    # CPU; elementwise, so the values are the single-thread exp's, and the
    # caller's thread count is back afterwards.
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(64, 4, 33, 65)).astype(np.float32))
    with host_threads():
        threads = torch.get_num_threads()
        got = plain_exp(x)
        assert torch.get_num_threads() == threads
    assert torch.equal(got, torch.exp(x))  # the suite's own one thread


def test_dispatch_by_device_and_counters_stay_still_on_the_cpu():
    q, k, v = (t(x) for x in _qkv(8, 2, 16, 2, 16))
    before = [c.launches for c in fa.COUNTERS]
    assert torch.equal(best_attention(q, k, v, causal=True), full_attention(q, k, v, causal=True))
    assert torch.equal(flash_attention(q, k, v, causal=True),
                       fa.plain_flash_attention_forward(q, k, v, True)[0])
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    flash_attention(*leaves, causal=True).sum().backward()
    assert [c.launches for c in fa.COUNTERS] == before
    with pytest.raises(ValueError, match="device meta"):
        best_attention(*(x.to("meta") for x in (q, k, v)))
    with pytest.raises(ValueError, match="device meta"):
        flash_attention(*(x.to("meta") for x in (q, k, v)))


@pytest.mark.parametrize("head_dim,width", [
    (1, 8), (8, 8), (9, 16), (24, 32), (32, 32), (48, 64), (100, 128), (128, 128),
    (129, 256), (200, 256), (256, 256),
])
def test_kernel_head_dim_is_the_next_built_one(head_dim, width):
    # On the card a head dim the kernels are not built for runs zero-padded to
    # the next one they are built for.
    assert fa.kernel_head_dim(head_dim) == width and width in fa.HEAD_DIMS


@pytest.mark.parametrize("head_dim", [257, 384, 1000])
def test_kernel_head_dim_refuses_past_the_widest(head_dim):
    # The narrow kernels stop at 256 and never pad past it: every wider head
    # dim takes the wide route (kernels/flash_attention_wide.py), through the
    # same dispatch on every device, here its plain version on the CPU.
    with pytest.raises(ValueError, match="head dims up to 256"):
        fa.kernel_head_dim(head_dim)
    assert fa.takes_wide_route(head_dim) and not fa.takes_wide_route(256)
    q, k, v = (t(x) for x in _qkv(head_dim, 1, 5, 1, head_dim))
    before = [c.launches for c in fa.COUNTERS + wide.COUNTERS]
    assert torch.equal(flash_attention(q, k, v, causal=True),
                       wide.plain_wide_forward(q, k, v, True)[0])
    assert [c.launches for c in fa.COUNTERS + wide.COUNTERS] == before


# The wide route's plain versions (the wide kernels' arithmetic: 16-row and
# 16-key tiles, each score summed over the head dim as 8 (forward) or 16
# (backward) partial sums added pairwise) at head dims 257 (rows that are not
# whole 16-byte pieces), 384, 512 (the widest one-slice head dim), 513 (the
# first of two 512-column output slices, the second one column wide) and 1000:
# the forward against the Pallas kernel in interpret mode (2e-5, as above),
# the backward against jax.grad of `full_attention`. The gradients reach 45
# here and dQ and dK sum over up to 1000 columns in another order than XLA's:
# the port is up to 5.0e-5 off jax.grad, and jax.grad itself up to 3.9e-5 off
# a float64 reference (scripts/torch_wide_backward_error.py), so 1e-5
# absolute cannot hold. The largest error is 1.6e-6 of the tensor's largest
# gradient (dK at D = 512, causal); they are held at 5e-6 of it, 3 times
# that, as at D = 256 above. S = 40 spans three query and key tiles, S = 100
# seven, the last of each ragged.
WIDE_DIMS = [257, 384, wide.WIDE_SLICE, wide.WIDE_SLICE + 1, 1000]


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [40, 100])
def test_wide_route_forward_matches_the_pallas_kernel(d, causal, s):
    q, k, v = _qkv(d + s, 2, s, 2, d)
    got, lse = wide.plain_wide_forward(t(q), t(k), t(v), causal, need_lse=True)
    np.testing.assert_allclose(n(got), _jax_flash(q, k, v, causal), atol=2e-5, rtol=2e-5)
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5
    if causal:
        scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    np.testing.assert_allclose(n(lse), np.asarray(jax.nn.logsumexp(scores, axis=-1)),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("causal,s", [(True, 40), (False, 100)])
def test_wide_route_backward_matches_jax_grad(d, causal, s):
    q, k, v = _qkv(d + 2, 2, s, 2, d)
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    (flash_attention(*leaves, causal=causal) ** 2).sum().backward()

    def loss(a, b, c):
        return (jax_full_attention(a, b, c, causal=causal) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(n(leaf.grad), w, rtol=0, atol=5e-6 * np.abs(w).max())


@pytest.mark.parametrize("parts", [8, 16])
@pytest.mark.parametrize("d", [64, 257, 1000])
def test_sliced_products_sum_the_kernels_parts_in_order(parts, d):
    # Part i sums the 4-column groups g with g % parts == i, chunk by chunk;
    # the parts are added pairwise as the kernels' shuffles add them. In
    # float64 against the product itself, and in float32 bitwise against the
    # same sums written out.
    a, b = (torch.from_numpy(x) for x in _qkv(d, 3, 5, 1, d)[:2])
    a, b = a[:, :, 0].double(), b[:, :, 0].double()
    torch.testing.assert_close(sliced_products(a, b, parts), a @ b.transpose(-1, -2),
                               rtol=0, atol=1e-12)
    a, b = a.float(), b.float()
    groups = torch.arange(d) // 4 % parts
    sums = [a[..., groups == i] @ b[..., groups == i].transpose(-1, -2) for i in range(parts)]
    while len(sums) > 1:
        sums = [sums[i] + sums[i + 1] for i in range(0, len(sums), 2)]
    assert torch.equal(sliced_products(a, b, parts), sums[0])


def test_wide_plain_backward_sums_tiles_in_order():
    # dV and dK over query tiles of 16 and dQ over key tiles of 16, in order:
    # equal to the unsplit products within float32 reassociation (1e-5
    # relative).
    q, k, v, dout = (t(x) for x in _qkv(5, 1, 40, 1, 300) + _qkv(6, 1, 40, 1, 300)[:1])
    o, lse = wide.plain_wide_forward(q, k, v, True, need_lse=True)
    got = wide.plain_wide_backward(q, k, v, o, lse, dout, True)
    want = fa.plain_flash_attention_backward(q, k, v, o, lse, dout, True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_wide_kernel_wrappers_refuse_cpu_tensors():
    q, k, v = (t(x) for x in _qkv(9, 1, 16, 1, 300))
    with pytest.raises(ValueError, match="one CUDA device"):
        wide.forward_kernel(q, k, v)
    o, lse = wide.plain_wide_forward(q, k, v, need_lse=True)
    with pytest.raises(ValueError, match="one CUDA device"):
        wide.backward_kernel(q, k, v, o, lse, o)
    pos = torch.arange(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        wide.chunk_kernel(q, k, v, pos, pos)


# The padded route (q, k, v zero-padded to the next built head dim, the scale
# of the true one, the padded columns cut off) through the kernels' plain
# versions, against the Pallas kernel at the true head dim in interpret mode
# (2e-5, as above) and its gradients against jax.grad of `full_attention`
# (1e-5 as above, and 1e-5 relative: at D = 100 the gradients reach 10, where
# the two orders of summation part by more than 1e-5).
@pytest.mark.parametrize("d,causal", [(5, True), (24, True), (24, False), (100, True)])
def test_padded_route_matches_the_pallas_kernel(d, causal):
    q, k, v = _qkv(d, 2, 20, 2, d)
    width = fa.kernel_head_dim(d)
    got = fa.padded_flash_attention(t(q), t(k), t(v), causal, width)
    assert got.shape == (2, 20, 2, d)
    np.testing.assert_allclose(n(got), _jax_flash(q, k, v, causal), atol=2e-5, rtol=2e-5)
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    (fa.padded_flash_attention(*leaves, causal, width) ** 2).sum().backward()

    def loss(a, b, c):
        return (jax_full_attention(a, b, c, causal=causal) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(n(leaf.grad), np.asarray(w), atol=1e-5, rtol=1e-5)


# C8: head dims 200 (padded to 256) and 256 (as built) through the kernels'
# plain versions, against the Pallas kernel in interpret mode (2e-5, as above)
# and jax.grad of `full_attention`. The gradients reach 15 to 20 here, and dQ
# and dK are sums over 200 to 256 columns taken in another order than XLA's:
# they are held at 5e-6 of the tensor's largest gradient (about 40 float32
# ulps of it), which also covers the entries whose exact value is 0 (the first
# causal row's dQ) and that both sides compute as a roundoff.
@pytest.mark.parametrize("d", [200, 256])
def test_wide_padded_route_matches_the_pallas_kernel(d):
    q, k, v = _qkv(d, 2, 20, 2, d)
    width = fa.kernel_head_dim(d)
    assert width == 256
    got = fa.padded_flash_attention(t(q), t(k), t(v), True, width)
    np.testing.assert_allclose(n(got), _jax_flash(q, k, v, True), atol=2e-5, rtol=2e-5)
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    (fa.padded_flash_attention(*leaves, True, width) ** 2).sum().backward()

    def loss(a, b, c):
        return (jax_full_attention(a, b, c, causal=True) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(n(leaf.grad), w, rtol=0, atol=5e-6 * np.abs(w).max())


def test_padded_chunk_matches_the_chunk_at_its_own_head_dim():
    # B3's padded route (ops/pallas_attention.py::flash_attention_chunk on the
    # card) through the kernel's plain version: the same fold over the same
    # keys, with zero columns added to each dot product; 1e-6.
    q, k, v = (t(x) for x in _qkv(12, 2, 24, 2, 12))
    q_pos = torch.arange(24, 48, dtype=torch.int32)
    k_pos = torch.arange(0, 48, 2, dtype=torch.int32)
    want = fac.plain_flash_attention_chunk(q, k, v, q_pos, k_pos, True)
    pv, m, l = fac.plain_flash_attention_chunk(*fa.pad_head_dim(16, q, k, v), q_pos, k_pos,
                                               True, scale=12**-0.5)
    assert pv.shape == (2, 24, 2, 16) and not pv[..., 12:].any()
    for g, w in zip((pv[..., :12], m, l), want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def test_plain_forward_float16_matches_the_pallas_kernel():
    # float16 q, k, v, which the kernels take: both widen to fp32 and round
    # the output once to float16; 2e-3, two float16 ulps in [1, 2).
    q, k, v = _qkv(16, 2, 40, 2, 32, dtype=np.float16)
    got = fa.plain_flash_attention_forward(t(q), t(k), t(v), True)[0]
    assert got.dtype == torch.float16
    want = _jax_flash(q, k, v, True, block_q=64, block_k=64)
    np.testing.assert_allclose(n(got.float()), want.astype(np.float32), atol=2e-3, rtol=2e-3)


def test_row_alignment_check():
    # The kernels move rows as 16-byte pieces. The views of a fused
    # [B, S, 3, H, D] projection are aligned at every head dim they take; a
    # view that starts 4 bytes into its buffer, or whose rows are 20 bytes
    # apart, is refused.
    for head_dim in fa.HEAD_DIMS:
        proj = torch.zeros((2, 5, 3, 2, head_dim))
        fa.check_rows_aligned("views", *(proj[:, :, i] for i in range(3)))
    flat = torch.zeros(2 * 5 * 2 * 16 + 1)
    shifted = flat[1:].view(2, 5, 2, 16)
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa.check_rows_aligned("the kernel", shifted)
    padded = torch.zeros((2, 5, 2, 21))[..., :16]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa.check_rows_aligned("the kernel", padded)
    fa.check_rows_aligned("one row", padded[:1, :1, :1])  # a lone row moves no stride


def test_kernel_wrappers_refuse_cpu_tensors():
    # A CPU tensor takes the plain version through the dispatch; the kernel
    # wrappers themselves launch on CUDA tensors only, and never fall back.
    q, k, v = (t(x) for x in _qkv(9, 1, 16, 1, 16))
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.forward_kernel(q, k, v)
    o, lse = fa.plain_flash_attention_forward(q, k, v, need_lse=True)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.backward_kernel(q, k, v, o, lse, o)
