"""The port's tensor-parallel block (parallel/tp.py) against the JAX
package's (stoix_tpu/parallel/tp.py, tests/test_tp.py), on the CPU.

1. `init_column_row_params` shapes, scales and its divisibility refusal;
   `reference_block` against the JAX `reference_block` on carried params
   (1e-6 relative); `tp_specs` names the sharded leaves.
2. On a 2 x 2 ("data", "model") mesh of gloo ranks (tests/torch_ring_worker.py),
   with the params of tests/test_tp.py carried over from the JAX package
   (its forward case at 2 model shards, and its backward case):
   - the forward rows against the port's `reference_block` and JAX's
     `column_row_block` under `shard_map` on the same 2 x 2 mesh: 1e-5
     relative (tests/test_tp.py's forward bar);
   - the data-mean loss of mean(out²) and its data-mean gradients of each
     rank's model shard against `jax.value_and_grad` of the JAX block under
     `shard_map` (tests/test_tp.py::test_backward_matches_oracle's step) and
     of the port's `reference_block` through torch autograd: the loss 1e-5
     relative, gradients 1e-4 relative and 1e-6 absolute (tests/test_tp.py's
     backward bar), and each rank's gradient of its rows of x against the
     reference's at the same bar;
   - exactly one all-reduce over the model axis forward and one backward
     (the input's gradient), both over the rank's model subgroup.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stoix_tpu.parallel import create_mesh as jax_create_mesh
from stoix_tpu.parallel import shard_map
from stoix_tpu.parallel import tp as jtp
from stoix_tpu_torch.parallel import tp
from torch_ring_worker import spawn_ranks


def _jax_case(seed_params, seed_x, d_in, d_hidden, d_out, batch):
    params = jtp.init_column_row_params(jax.random.PRNGKey(seed_params), d_in, d_hidden, d_out,
                                        num_shards=2)
    x = jax.random.normal(jax.random.PRNGKey(seed_x), (batch, d_in), jnp.float32)
    return jax.tree.map(np.asarray, params), np.asarray(x)


# tests/test_tp.py's forward case (at 2 model shards) and its backward case.
CASES = [_jax_case(0, 1, 6, 16, 3, 8), _jax_case(2, 3, 5, 8, 2, 4)]


def _torch(params):
    return tp.ColumnRowParams(*(torch.from_numpy(np.asarray(p)) for p in params))


def test_init_shapes_scales_and_refusal():
    params = tp.init_column_row_params(torch.Generator().manual_seed(0), 6, 16, 3, 4)
    assert [tuple(p.shape) for p in params] == [(4, 6, 4), (4, 4), (4, 4, 3), (3,)]
    assert not params.b1.any() and not params.b2.any()
    # Unit normals scaled by 1/sqrt(d_in) and 1/sqrt(d_hidden).
    assert 0.2 < float(params.w1.std()) * 6 ** 0.5 < 2.0
    assert 0.2 < float(params.w2.std()) * 16 ** 0.5 < 2.0
    with pytest.raises(ValueError, match="not divisible"):
        tp.init_column_row_params(torch.Generator(), 4, 10, 2, num_shards=4)
    assert tp.tp_specs() == (tp.ColumnRowParams("model", "model", "model", None), "data")
    shard = tp.shard_params(params, 2)
    assert torch.equal(shard.w1[0], params.w1[2]) and shard.b2 is params.b2


@pytest.mark.parametrize("case", [0, 1])
def test_reference_block_matches_jax(case):
    params, x = CASES[case]
    want = np.asarray(jtp.reference_block(params, jnp.asarray(x)))
    got = tp.reference_block(_torch(params), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks([("tp", "tp_block", dict(cases=CASES))], 4,
                       tmp_path_factory.mktemp("tp_ranks"))


def _jax_mesh():
    return jax_create_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])


@pytest.mark.parametrize("case", [0, 1])
def test_forward_rows_match_the_reference_and_jax(ranks, case):
    params, x = CASES[case]
    param_specs, data_spec = jtp.tp_specs()
    jax_fwd = jax.jit(shard_map(partial(jtp.column_row_block, axis_name="model"),
                                mesh=_jax_mesh(), in_specs=(param_specs, data_spec),
                                out_specs=data_spec))
    want_jax = np.asarray(jax_fwd(params, jnp.asarray(x)))
    want = tp.reference_block(_torch(params), torch.from_numpy(x)).numpy()
    rows = x.shape[0] // 2
    for result in ranks:
        got = result["tp"][case]
        d = got["data_rank"]
        np.testing.assert_allclose(got["out"], want[d * rows:(d + 1) * rows], rtol=1e-5)
        np.testing.assert_allclose(got["out"], want_jax[d * rows:(d + 1) * rows], rtol=1e-5)


@pytest.mark.parametrize("case", [0, 1])
def test_gradients_match_jax_and_the_reference(ranks, case):
    params, x = CASES[case]
    param_specs, data_spec = jtp.tp_specs()

    def step(p, x):
        def sharded_loss(p, x):
            return jax.lax.pmean(jnp.mean(jtp.column_row_block(p, x, axis_name="model") ** 2),
                                 "data")

        loss, grads = jax.value_and_grad(sharded_loss)(p, x)
        return loss, jax.lax.pmean(grads, "data")

    jax_loss, jax_grads = jax.jit(shard_map(step, mesh=_jax_mesh(),
                                            in_specs=(param_specs, data_spec),
                                            out_specs=(P(), param_specs)))(params, x)
    full = tp.ColumnRowParams(*(p.clone().requires_grad_(True) for p in _torch(params)))
    x_full = torch.from_numpy(x).requires_grad_(True)
    ref_loss = torch.mean(tp.reference_block(full, x_full) ** 2)
    ref_loss.backward()
    rows = x.shape[0] // 2
    for result in ranks:
        got = result["tp"][case]
        m, d = got["model_rank"], got["data_rank"]
        # The input's gradient: the model axis's shards' parts all-reduced.
        np.testing.assert_allclose(got["x_grad"], x_full.grad.numpy()[d * rows:(d + 1) * rows],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["loss"], float(jax_loss), rtol=1e-5)
        np.testing.assert_allclose(got["loss"], float(ref_loss), rtol=1e-5)
        for name, g, jg, rg in zip(tp.ColumnRowParams._fields, got["grads"], jax_grads,
                                   (p.grad for p in full)):
            shard = slice(m, m + 1) if name != "b2" else slice(None)
            np.testing.assert_allclose(g, np.asarray(jg)[shard], rtol=1e-4, atol=1e-6,
                                       err_msg=name)
            np.testing.assert_allclose(g, rg.numpy()[shard], rtol=1e-4, atol=1e-6,
                                       err_msg=name)


def test_one_all_reduce_over_the_model_axis_each_way(ranks):
    for rank, result in enumerate(ranks):
        for got in result["tp"]:
            model_group = tuple(sorted({rank, rank ^ 1}))  # r and r ^ 1: one data index
            assert got["forward_reduces"] == [model_group]
            assert got["backward_reduces"] == [model_group]
