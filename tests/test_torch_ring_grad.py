"""The gradients of the PyTorch port's ring attention across ranks (ROADMAP
C27) against `jax.grad` of the JAX package's ring, on the CPU.

The ring moves K/V between ranks by point-to-point sends, which autograd does
not cross: before C27 was repaired a backward through the `use_flash=False`
ring kept only each rank's own queries' share of its dK and dV, and under
`use_flash=True` the forward-only kernel B3 left no graph at all. The JAX
package's `use_flash=False` ring is differentiable (`ppermute` has a
transpose) and its `use_flash=True` ring raises (`pallas_call` has no VJP,
C5).

- On 2 and 4 gloo ranks (spawned processes, tests/torch_ring_worker.py, one
  spawn a rank count), dQ, dK and dV of sum(ring(q, k, v) * cotangent), each
  rank's shards, causal and not, against `jax.grad` of the same sum through
  JAX's `ring_attention(use_flash=False)` under `shard_map` on the first 2
  or 4 of the 8 virtual devices: within 1e-5 of each gradient's largest
  entry; the outputs within 2e-5 (the ring's forward bar).
- `use_flash=True` with a gradient required raises, naming C5.
- A one-rank ring's gradients against JAX's `full_attention`'s: 1e-5 of
  each gradient's largest entry.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from stoix_tpu.ops.ring_attention import full_attention as jax_full_attention
from stoix_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from stoix_tpu.parallel import create_mesh as jax_create_mesh
from stoix_tpu.parallel import shard_map
from torch_ring_worker import spawn_ranks

GRAD_TOL = 1e-5  # of each gradient's largest entry
OUT_TOL = 2e-5
RING = (2, 64, 4, 16)  # tests/test_ring_attention.py's q, k, v shape
ONE = (2, 16, 4, 16)
DATA = dict(axes={"data": -1}, axis="data")


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(4))


def _jobs():
    q, k, v, w = _inputs(0, RING)
    jobs = [(f"grad-{causal}", "ring_grad", dict(DATA, q=q, k=k, v=v, cotangent=w, causal=causal))
            for causal in (False, True)]
    jobs.append(("flash", "ring_grad", dict(DATA, q=q, k=k, v=v, cotangent=w, causal=True,
                                            use_flash=True)))
    q1, k1, v1, w1 = _inputs(1, ONE)
    jobs.append(("one-rank", "ring_grad", dict(axes={"data": 1, "seq": -1}, axis="data", q=q1,
                                               k=k1, v=v1, cotangent=w1, causal=True)))
    return jobs


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, spawn_ranks(_jobs(), world, tmp_path_factory.mktemp(f"ring_grad_{world}"))


def _gathered(results, name, key):
    return np.concatenate([r[name][key] for r in results], axis=1)


def _jax_grads(world, q, k, v, w, causal):
    mesh = jax_create_mesh({"data": world}, devices=jax.devices()[:world])
    spec = P(None, "data")
    ring = shard_map(partial(jax_ring_attention, axis_name="data", causal=causal,
                             use_flash=False),
                     mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)

    def loss(q, k, v):
        out = ring(q, k, v)
        return jnp.sum(out * w), out

    grads, out = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assert_grads(got, want):
    for name, g, ref in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == ref.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, ref, rtol=0, atol=GRAD_TOL * float(np.abs(ref).max()),
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradients_across_ranks_match_jax_grad(ranks, causal):
    world, results = ranks
    q, k, v, w = _inputs(0, RING)
    out, want = _jax_grads(world, q, k, v, w, causal)
    name = f"grad-{causal}"
    np.testing.assert_allclose(_gathered(results, name, "out"), out, atol=OUT_TOL, rtol=OUT_TOL)
    _assert_grads([_gathered(results, name, key) for key in ("dq", "dk", "dv")], want)


def test_flash_ring_under_grad_is_refused_naming_c5(ranks):
    _, results = ranks
    for result in results:
        assert "C5" in result["flash"]["refused"]
        assert "forward only" in result["flash"]["refused"]


def test_one_rank_ring_gradients_match_full_attention(ranks):
    _, results = ranks
    q, k, v, w = _inputs(1, ONE)

    def loss(q, k, v):
        return jnp.sum(jax_full_attention(q, k, v, causal=True) * w)

    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))]
    for result in results:  # every rank is its own one-rank ring
        _assert_grads([result["one-rank"][key] for key in ("dq", "dk", "dv")], want)
