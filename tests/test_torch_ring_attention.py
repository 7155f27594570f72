"""Kernel B3 (flash attention over one K/V chunk) and ring attention of the
PyTorch port against the JAX package, on the CPU.

- B3's plain version (kernels/flash_attention_chunk.py, the CUDA kernel's
  arithmetic) against stoix_tpu/ops/pallas_attention.py::flash_attention_chunk
  in interpret mode, on the inputs of tests/test_pallas_attention.py::
  test_chunk_kernel_folds_to_full_attention (b=2, s=192, h=2, d=32, three
  chunks of 64, blocks of 64), causal and not, and on a chunk wholly in the
  queries' future. Tolerance 2e-5 (that test's): m absolute, l and pv relative
  to the row's l (pv is the unnormalised sum, so its scale is l's). Both fold
  the online softmax over other tile sizes.
- B3's plain version on a chunk of two 64-key tiles with shuffled positions
  against the JAX package's `_block_attend` (masked by each key's position):
  2e-5, measured as above.
- The three-chunk fold against JAX's full attention: 2e-5.
- Ring attention on 4 gloo ranks (spawned processes, tests/torch_ring_worker.py,
  one spawn for the whole module) against JAX's ring_attention on a 4-device
  mesh, with `use_flash` False and True, causal and not: 2e-5 (JAX's own
  tolerance for the ring). A one-rank ring against full attention, the causal
  ring's independence from future keys, and the transformer torso with the
  ring as its attention against JAX's sharded apply: 2e-4 (tests/
  test_attention.py's).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stoix_tpu.networks.attention import TransformerTorso as JaxTransformerTorso
from stoix_tpu.ops.pallas_attention import flash_attention_chunk as jax_flash_attention_chunk
from stoix_tpu.ops.ring_attention import _block_attend as jax_block_attend
from stoix_tpu.ops.ring_attention import full_attention as jax_full_attention
from stoix_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from stoix_tpu.parallel import create_mesh as jax_create_mesh
from stoix_tpu.parallel import shard_map
from stoix_tpu_torch.kernels import flash_attention_chunk as chunk
from stoix_tpu_torch.kernels import flash_attention_wide as wide
from stoix_tpu_torch.ops.pallas_attention import flash_attention_chunk
from stoix_tpu_torch.ops.ring_attention import full_attention
from torch_parity import n, t
from torch_ring_worker import spawn_ranks

TOL = 2e-5
B, S, H, D = 2, 192, 2, 32  # tests/test_pallas_attention.py::test_chunk_kernel_folds_...
CHUNK = S // 3
WORLD = 4
RING = (2, 64, 4, 16)  # tests/test_ring_attention.py's q, k, v shape
TORSO = dict(num_layers=1, num_heads=2, head_dim=8, ffn_dim=32)


def _qkv(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))


def assert_chunk_close(got, want, tol=TOL):
    """pv, m, l of one chunk: m within `tol`; l and pv within `tol` times the
    row's l (at least 1)."""
    got, want = ([torch.as_tensor(np.asarray(x, np.float64)) for x in r] for r in (got, want))
    assert [x.shape for x in got] == [x.shape for x in want] and got[1].shape == got[2].shape
    errors = chunk.chunk_errors(got, want)
    assert max(errors) <= tol, f"m, l, pv errors {errors} above {tol}"


def _chunk_inputs(c, q_rows=S):
    q, k, v = _qkv(4, B, S, H, D)
    keys = slice(c * CHUNK, (c + 1) * CHUNK)
    q_pos = np.arange(q_rows, dtype=np.int32)
    k_pos = np.arange(c * CHUNK, (c + 1) * CHUNK, dtype=np.int32)
    return q[:, :q_rows], k[:, keys], v[:, keys], q_pos, k_pos


def _jax_chunk(q, k, v, q_pos, k_pos, causal):
    out = jax_flash_attention_chunk(*map(jnp.asarray, (q, k, v, q_pos, k_pos)), causal=causal,
                                    block_q=64, block_k=64, interpret=True)
    return tuple(np.asarray(x) for x in out)


def _port_chunk(q, k, v, q_pos, k_pos, causal):
    out = flash_attention_chunk(*map(t, (q, k, v, q_pos, k_pos)), causal=causal,
                                block_q=64, block_k=64)
    return tuple(n(x) for x in out)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("c", [0, 1, 2])
def test_plain_chunk_matches_the_pallas_kernel(causal, c):
    inputs = _chunk_inputs(c)
    before = chunk.KERNEL.launches
    got = _port_chunk(*inputs, causal)
    assert chunk.KERNEL.launches == before  # a CPU tensor takes the plain version
    assert got[0].dtype == got[1].dtype == got[2].dtype == np.float32
    assert_chunk_close(got, _jax_chunk(*inputs, causal))


# B3 past head dim 256: the wide chunk kernel's plain version (16-key tiles,
# each score summed over the head dim as 8 partial sums) through the
# dispatch, against the Pallas chunk kernel in interpret mode, a visible, a
# diagonal and a future chunk of 64 keys (four key tiles) at head dims 257,
# 384, 512 (one 512-column output slice), 513 (two) and 1000; 2e-5 as above.
@pytest.mark.parametrize("d", [257, 384, wide.WIDE_SLICE, wide.WIDE_SLICE + 1, 1000])
@pytest.mark.parametrize("q_start,k_start", [(64, 0), (64, 64), (0, 64)])
def test_wide_plain_chunk_matches_the_pallas_kernel(d, q_start, k_start):
    q, k, v = _qkv(d, 1, 64, 2, d)
    q_pos = np.arange(q_start, q_start + 64, dtype=np.int32)
    k_pos = np.arange(k_start, k_start + 64, dtype=np.int32)
    before = [c.launches for c in wide.COUNTERS]
    got = _port_chunk(q, k, v, q_pos, k_pos, True)
    assert [c.launches for c in wide.COUNTERS] == before
    assert_chunk_close(got, _jax_chunk(q, k, v, q_pos, k_pos, True))
    want = wide.plain_wide_chunk(*map(t, (q, k, v, q_pos, k_pos)), True)
    assert all(np.array_equal(g, n(w)) for g, w in zip(got, want))


def test_chunk_wholly_in_the_future_gives_the_proxy_stats():
    # Queries 0..63 against keys 128..191: every key is in every query's
    # future, so both kernels write m = 0 (the finite proxy), l = 0, pv = 0.
    inputs = _chunk_inputs(2, q_rows=CHUNK)
    got, want = _port_chunk(*inputs, True), _jax_chunk(*inputs, True)
    for g, w in zip(got, want):
        assert not np.any(w) and np.array_equal(g, w)


def test_plain_chunk_across_key_tiles_with_shuffled_positions_matches_jax():
    # A chunk of 100 keys (two of the plain version's 64-key tiles, the second
    # ragged) with shuffled global positions, against the JAX package's
    # one-block attend (`_block_attend`, which masks each key by its own
    # position; the Pallas kernel bounds its walk by assuming ascending
    # positions). Some queries see no key of the chunk: m = 0, l = 0, pv = 0.
    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 80, 2, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 100, 2, 32)).astype(np.float32) for _ in range(2))
    q_pos = np.arange(20, 100, dtype=np.int32)
    k_pos = rng.permutation(np.arange(30, 130)).astype(np.int32)
    got = tuple(n(x) for x in chunk.plain_flash_attention_chunk(*map(t, (q, k, v, q_pos, k_pos)),
                                                                 causal=True))
    mask = jnp.asarray(q_pos[:, None] >= k_pos[None, :])[None, None]
    m, pv, l = jax_block_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 32**-0.5, mask)
    assert_chunk_close(got, (pv, m, l))
    empty = q_pos < k_pos.min()
    assert empty.any() and not got[2][:, :, empty].any() and not got[0][:, empty].any()


@pytest.mark.parametrize("causal", [False, True])
def test_chunks_fold_to_full_attention(causal):
    # The fold of tests/test_pallas_attention.py:74-96, over the plain chunks.
    q, k, v = _qkv(4, B, S, H, D)
    m_acc = torch.full((B, H, S), float("-inf"))
    l_acc = torch.zeros((B, H, S))
    o_acc = torch.zeros((B, S, H, D))
    for c in range(3):
        pv, m, l = (t(x) for x in _port_chunk(*_chunk_inputs(c), causal))
        m_new = torch.maximum(m_acc, m)
        alpha, beta = torch.exp(m_acc - m_new), torch.exp(m - m_new)
        l_acc = l_acc * alpha + l * beta
        o_acc = o_acc * alpha.permute(0, 2, 1)[..., None] + pv * beta.permute(0, 2, 1)[..., None]
        m_acc = m_new
    got = o_acc / torch.where(l_acc == 0.0, 1.0, l_acc).permute(0, 2, 1)[..., None]
    want = jax_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=TOL, rtol=TOL)


def test_block_sizes_must_divide_the_chunk_lengths_as_in_jax():
    q, k, v, q_pos, k_pos = _chunk_inputs(0)
    match = "block sizes must divide the chunk lengths"
    with pytest.raises(ValueError, match=match):
        jax_flash_attention_chunk(*map(jnp.asarray, (q, k, v, q_pos, k_pos)), block_q=128,
                                  interpret=True)
    with pytest.raises(ValueError, match=match):
        flash_attention_chunk(*map(t, (q, k, v, q_pos, k_pos)), block_q=128)


def test_chunk_dispatch_by_device():
    q, k, v, q_pos, k_pos = map(t, _chunk_inputs(1))
    want = chunk.plain_flash_attention_chunk(q, k, v, q_pos, k_pos, True)
    for g, w in zip(flash_attention_chunk(q, k, v, q_pos.long(), k_pos.long(), True, 64, 64),
                    want):
        assert torch.equal(g, w)  # positions of any integer type, cast to int32
    with pytest.raises(ValueError, match="one CUDA device"):
        chunk.chunk_kernel(q, k, v, q_pos, k_pos)  # the kernel never takes CPU tensors
    with pytest.raises(ValueError, match="device meta"):
        flash_attention_chunk(*(x.to("meta") for x in (q, k, v, q_pos, k_pos)), True, 64, 64)


# ---------------------------------------------------------------- the ring on 4 ranks


def _ring_inputs():
    q, k, v = _qkv(0, *RING)
    k_future, v_future = k.copy(), v.copy()
    k_future[:, 32:] += 7.0
    v_future[:, 32:] -= 3.0
    return q, k, v, k_future, v_future


def _torso_inputs():
    x = np.random.default_rng(5).normal(size=(2, 64, 5)).astype(np.float32)
    params = jax.tree.map(np.asarray, JaxTransformerTorso(**TORSO).init(
        jax.random.PRNGKey(1), jnp.asarray(x)))
    # Each rank embeds its local time slice: zero the positional embedding so
    # local and global positions give the same result (tests/test_attention.py).
    params["params"]["positional_embedding"] = np.zeros_like(
        params["params"]["positional_embedding"])
    return x, params


RING_CASES = [(causal, use_flash) for causal in (False, True) for use_flash in (False, True)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every multi-process case of this module, in one spawn of 4 gloo ranks."""
    q, k, v, k_future, v_future = _ring_inputs()
    one = _qkv(3, 2, 16, 4, 16)
    x, params = _torso_inputs()
    data = dict(axes={"data": -1}, axis="data")
    jobs = [(f"ring-{causal}-{use_flash}", "ring",
             dict(data, q=q, k=k, v=v, causal=causal, use_flash=use_flash))
            for causal, use_flash in RING_CASES]
    jobs += [
        ("causal", "ring", dict(data, q=q, k=k, v=v, causal=True)),
        ("causal-future", "ring", dict(data, q=q, k=k_future, v=v_future, causal=True)),
        ("one-rank", "ring", dict(axes={"data": 1, "seq": -1}, axis="data", q=one[0], k=one[1],
                                  v=one[2], causal=False)),
        ("torso", "torso", dict(params=params, x=x, torso_kwargs=TORSO)),
    ]
    return spawn_ranks(jobs, WORLD, tmp_path_factory.mktemp("ring_ranks"))


def _gathered(ranks, name):
    """The ranks' output shards of one job, in rank order along the sequence."""
    return np.concatenate([r[name] for r in ranks], axis=1)


def _jax_ring(q, k, v, causal, use_flash):
    mesh = jax_create_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    spec = P(None, "data")
    ring = jax.jit(shard_map(
        partial(jax_ring_attention, axis_name="data", causal=causal, use_flash=use_flash),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        # As tests/test_pallas_attention.py: the Pallas interpreter trips the
        # varying-axes check under shard_map.
        check_vma=not use_flash,
    ))
    return np.asarray(ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("causal,use_flash", RING_CASES)
def test_four_rank_ring_matches_the_jax_ring(ranks, causal, use_flash):
    q, k, v = _ring_inputs()[:3]
    got = _gathered(ranks, f"ring-{causal}-{use_flash}")
    assert got.shape == q.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, _jax_ring(q, k, v, causal, use_flash), atol=TOL, rtol=TOL)
    want = jax_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_ring_on_cpu_ranks_launches_no_kernel(ranks):
    # use_flash=True on CPU tensors runs B3's plain version, never the kernel.
    assert [r["chunk_kernel_launches"] for r in ranks] == [0] * WORLD


def test_one_rank_ring_degenerates_to_full_attention(ranks):
    # tests/test_ring_attention.py:60-67: every rank is its own one-rank ring
    # over the whole sequence.
    q, k, v = _qkv(3, 2, 16, 4, 16)
    want = np.asarray(jax_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    for rank in ranks:
        np.testing.assert_allclose(rank["one-rank"], want, atol=TOL, rtol=TOL)


def test_causal_ring_ignores_future_keys(ranks):
    # tests/test_ring_attention.py:44-57: changing keys and values from
    # position 32 on must not change the outputs before it.
    out, out_future = _gathered(ranks, "causal"), _gathered(ranks, "causal-future")
    np.testing.assert_allclose(out[:, :32], out_future[:, :32], rtol=1e-5, atol=1e-5)
    assert not np.allclose(out[:, 32:], out_future[:, 32:])
    np.testing.assert_array_equal(out, _gathered(ranks, "ring-True-False"))


def test_ring_torso_matches_the_jax_sharded_apply(ranks):
    # tests/test_attention.py:41-81 on 4 ranks: the same params, the ring as
    # the attention with the time axis sharded, against JAX's sharded apply.
    x, params = _torso_inputs()
    ring_torso = JaxTransformerTorso(**TORSO, attention_fn=partial(jax_ring_attention,
                                                                   axis_name="data"))
    mesh = jax_create_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    sharded_apply = jax.jit(shard_map(ring_torso.apply, mesh=mesh,
                                      in_specs=(P(), P(None, "data")),
                                      out_specs=P(None, "data")))
    want = np.asarray(sharded_apply(params, jnp.asarray(x)))
    got = _gathered(ranks, "torso")
    assert got.shape == (2, 64, 16)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    full = JaxTransformerTorso(**TORSO).apply(params, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(full), rtol=2e-4, atol=2e-4)


def test_full_attention_of_the_port_is_the_ring_reference():
    q, k, v = _ring_inputs()[:3]
    got = full_attention(t(q), t(k), t(v), causal=True)
    want = jax_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6, rtol=0)
