"""The port's item buffer (stoix_tpu_torch/buffers/buffers.py) against the JAX
package's `make_item_buffer` on the same items, on the CPU: adds with
wraparound and batches of several sizes (the warmup's and the rollout's),
`insert_pos` and `num_added`, and the gather of the indices JAX's sample
drew: exact. Then tests/test_buffers.py's two item-buffer oracles
(wraparound keeps only the last writes; nothing unwritten is sampled) on the
port's own sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stoix_tpu.buffers import make_item_buffer as jax_make_item_buffer
from stoix_tpu_torch.buffers import make_item_buffer
from torch_parity import n, t


def _item_batch(rng, size):
    return {
        "obs": rng.normal(size=(size, 3)).astype(np.float32),
        "action": rng.integers(0, 4, size).astype(np.int32),
        "done": rng.random(size) > 0.5,
    }


def test_item_buffer_matches_jax_with_the_same_indices():
    rng = np.random.default_rng(0)
    kwargs = dict(max_length=50, min_length=8, sample_batch_size=16)
    jbuf, tbuf = jax_make_item_buffer(**kwargs, add_batch_size=12), make_item_buffer(**kwargs)
    dummy = _item_batch(rng, 1)
    jstate = jbuf.init(jax.tree.map(lambda x: jnp.asarray(x[0]), dummy))
    tstate = tbuf.init({k: t(v[0]) for k, v in dummy.items()})
    assert not tbuf.can_sample(tstate)
    key = jax.random.PRNGKey(0)
    for size in (20, 12, 12, 12, 12, 7):  # a warmup-sized add, then wraparound
        batch = _item_batch(rng, size)
        jstate = jbuf.add(jstate, jax.tree.map(jnp.asarray, batch))
        tstate = tbuf.add(tstate, {k: t(v) for k, v in batch.items()})
        assert (tstate.insert_pos, tstate.num_added) == (int(jstate.insert_pos),
                                                         int(jstate.num_added))
        for k in batch:
            assert np.array_equal(n(tstate.experience[k]), np.asarray(jstate.experience[k]))
        key, sample_key = jax.random.split(key)
        want = jbuf.sample(jstate, sample_key).experience
        current = min(int(jstate.num_added), kwargs["max_length"])
        indices = np.asarray(jax.random.randint(sample_key, (16,), 0, current))
        got = tbuf.gather(tstate, t(indices).long()).experience
        for k in batch:
            assert np.array_equal(n(got[k]), np.asarray(want[k]))
        assert tbuf.can_sample(tstate) == bool(jbuf.can_sample(jstate))


def test_item_buffer_add_sample_wraparound():
    # tests/test_buffers.py::test_item_buffer_add_sample_wraparound's oracle.
    buf = make_item_buffer(max_length=16, min_length=8, sample_batch_size=32)
    state = buf.init({"x": torch.zeros(())})
    assert not buf.can_sample(state)
    for i in range(10):  # 40 items into a 16-slot buffer: wraps
        state = buf.add(state, {"x": torch.full((4,), float(i))})
    assert buf.can_sample(state)
    vals = n(buf.sample(state, torch.Generator().manual_seed(0)).experience["x"])
    assert vals.shape == (32,)
    assert set(np.unique(vals)).issubset({6.0, 7.0, 8.0, 9.0})


def test_item_buffer_no_sampling_of_unwritten():
    # tests/test_buffers.py::test_item_buffer_no_sampling_of_unwritten's oracle.
    buf = make_item_buffer(max_length=100, min_length=1, sample_batch_size=64)
    state = buf.init({"x": torch.zeros(())})
    state = buf.add(state, {"x": torch.tensor([7.0, 7.0])})
    sample = buf.sample(state, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(n(sample.experience["x"]), 7.0)


def test_sampling_draws_from_the_generator_and_stays_on_its_device():
    buf = make_item_buffer(max_length=10, min_length=1, sample_batch_size=500)
    state = buf.add(buf.init({"x": torch.zeros((), dtype=torch.int64)}),
                    {"x": torch.arange(10)})
    a = buf.sample_indices(state, torch.Generator().manual_seed(5))
    b = buf.sample_indices(state, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.device.type == "cpu"
    assert set(n(a).tolist()) == set(range(10))
