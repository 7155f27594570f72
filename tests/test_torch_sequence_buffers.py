"""The port's trajectory and prioritised trajectory buffers
(stoix_tpu_torch/buffers/buffers.py) against the JAX package's, on the CPU.

1. Adds with wraparound at periods 1 and 4 (chunks shorter and longer than a
   period, a chunk past the capacity): the experience, `insert_pos`,
   `num_added`, the valid starts after the wrap and, for the prioritised
   buffer, the max-priority slots `add` writes: exact.
2. Samples from the draws JAX made (its row and start-period indices, its
   uniforms): the trajectory buffer's sequences exact; the prioritised
   buffer's sequences and indices exact on priority tables whose float32
   sums are exact (small integers, dyadic values), its probabilities 1e-6
   relative.
3. `set_priorities` with duplicate indices keeps the last occurrence, as
   JAX's `.at[].set` does on the CPU: 1e-6 relative (`(|p| + 1e-6) ** a` is
   a power in each package).
4. tests/test_buffers.py's trajectory and prioritised oracles and the debug
   sample guard's typed error, on the port's own samplers; the static guard
   `require_first_add_samplable` and the sizing of the sequence buffers.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.buffers import buffers as jbuffers
from stoix_tpu.systems import off_policy_core as jcore
from stoix_tpu.utils.config import Config as JaxConfig
from stoix_tpu_torch.buffers import (
    EmptyBufferSampleError, make_flat_buffer, make_item_buffer,
    make_prioritised_trajectory_buffer, make_trajectory_buffer, set_sample_guard,
)
from stoix_tpu_torch.buffers.buffers import _valid_starts, duplicate_indices
from stoix_tpu_torch.systems import off_policy_core as core
from stoix_tpu_torch.utils.config import Config
from torch_parity import n, t

ROWS, CAPACITY, SEQ = 3, 16, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def sample_guard():
    previous = set_sample_guard(True)
    yield
    set_sample_guard(previous)


def _chunk(rng, length):
    """A [ROWS, length] chunk of a nested item: a tuple carry, a dict leaf."""
    return {"obs": rng.normal(size=(ROWS, length, 2)).astype(np.float32),
            "carry": (rng.normal(size=(ROWS, length, 3)).astype(np.float32),
                      rng.integers(0, 9, (ROWS, length)).astype(np.int32)),
            "done": rng.random((ROWS, length)) < 0.3}


def _dummy():
    return {"obs": np.zeros(2, np.float32), "carry": (np.zeros(3, np.float32), np.int32(0)),
            "done": np.bool_(False)}


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch_tree(tree):
    return jax.tree.map(lambda x: t(np.asarray(x)), tree)


def _assert_tree_equal(got, want):
    for g, w in zip(jax.tree.leaves(jax.tree.map(n, got, is_leaf=torch.is_tensor)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))


# The chunk lengths of each add: shorter and longer than a period, then past
# the capacity so the buffer wraps (twice at the end).
CHUNKS = (3, 5, 8, 6, 9, 20)


@pytest.mark.parametrize("period", [1, 4])
def test_trajectory_buffer_matches_jax_on_the_same_draws(period):
    kwargs = dict(add_batch_size=ROWS, sample_batch_size=12, sample_sequence_length=SEQ,
                  period=period, max_length_time_axis=CAPACITY)
    jbuf, tbuf = jbuffers.make_trajectory_buffer(**kwargs), make_trajectory_buffer(**kwargs)
    jstate, tstate = jbuf.init(_jax_tree(_dummy())), tbuf.init(_torch_tree(_dummy()))
    rng, key = np.random.default_rng(period), jax.random.PRNGKey(period)
    for length in CHUNKS:
        chunk = _chunk(rng, length)
        jstate = jbuf.add(jstate, _jax_tree(chunk))
        tstate = tbuf.add(tstate, _torch_tree(chunk))
        assert (tstate.insert_pos, tstate.num_added) == (int(jstate.insert_pos),
                                                         int(jstate.num_added))
        _assert_tree_equal(tstate.experience, jstate.experience)
        assert _valid_starts(tstate, CAPACITY, SEQ) == tuple(
            int(x) for x in jbuffers._valid_starts(jstate, CAPACITY, SEQ))
        assert tbuf.can_sample(tstate) == bool(jbuf.can_sample(jstate))
        # JAX's draws (stoix_tpu/buffers/buffers.py:sample), fed to the port.
        key, sample_key = jax.random.split(key)
        row_key, start_key = jax.random.split(sample_key)
        n_starts, _ = jbuffers._valid_starts(jstate, CAPACITY, SEQ)
        rows = jax.random.randint(row_key, (12,), 0, ROWS)
        periods = jax.random.randint(start_key, (12,), 0, jnp.maximum(n_starts // period, 1))
        got = tbuf.sample_from(tstate, t(rows).long(), t(periods).long()).experience
        _assert_tree_equal(got, jbuf.sample(jstate, sample_key).experience)
    # After the wrap a sequence never crosses the write head.
    assert tstate.num_added > CAPACITY
    assert _valid_starts(tstate, CAPACITY, SEQ) == (CAPACITY - SEQ, tstate.insert_pos)


def _prioritised_pair(period, seq=SEQ, rows=ROWS, capacity=CAPACITY, exponent=0.6):
    kwargs = dict(add_batch_size=rows, sample_batch_size=64, sample_sequence_length=seq,
                  period=period, max_length_time_axis=capacity, priority_exponent=exponent)
    return (jbuffers.make_prioritised_trajectory_buffer(**kwargs),
            make_prioritised_trajectory_buffer(**kwargs))


def _with_priorities(jstate, tstate, table):
    return (jstate._replace(priorities=jnp.asarray(table)),
            tstate._replace(priorities=t(table)))


@pytest.mark.parametrize("period", [1, 4])
def test_prioritised_buffer_matches_jax_on_the_same_uniforms(period):
    jbuf, tbuf = _prioritised_pair(period)
    jstate, tstate = jbuf.init(_jax_tree(_dummy())), tbuf.init(_torch_tree(_dummy()))
    rng, key = np.random.default_rng(10 + period), jax.random.PRNGKey(10 + period)
    for step, length in enumerate(CHUNKS):
        chunk = _chunk(rng, length)
        jstate = jbuf.add(jstate, _jax_tree(chunk))
        tstate = tbuf.add(tstate, _torch_tree(chunk))
        assert (tstate.insert_pos, tstate.num_added) == (int(jstate.insert_pos),
                                                         int(jstate.num_added))
        _assert_tree_equal(tstate.experience, jstate.experience)
        # add's max-priority slots, exactly.
        np.testing.assert_array_equal(n(tstate.priorities), np.asarray(jstate.priorities))
        if not bool(jbuf.can_sample(jstate)):
            continue
        # A table with an exact float32 sum: small integers, some dyadic
        # fractions, zeros (unsampleable slots), and the largest above 1 so
        # the next add writes it.
        table = rng.integers(0, 6, (ROWS, CAPACITY // period)).astype(np.float32)
        table[:, ::3] *= 0.25 if step % 2 else 2.0
        jstate, tstate = _with_priorities(jstate, tstate, table)
        key, sample_key = jax.random.split(key)
        uniforms = jax.random.uniform(sample_key, (64,))
        want = jbuf.sample(jstate, sample_key)
        got = tbuf.sample_from_uniforms(tstate, t(uniforms))
        _assert_tree_equal(got.experience, want.experience)
        np.testing.assert_array_equal(n(got.indices), np.asarray(want.indices))
        np.testing.assert_allclose(n(got.probabilities), np.asarray(want.probabilities),
                                   rtol=1e-6, atol=0)
        # Every sampled slot is valid: a sequence inside the written data.
        n_starts, oldest = _valid_starts(tstate, CAPACITY, SEQ)
        offsets = (n(got.indices)[:, 1] * period - oldest) % CAPACITY
        assert (offsets < n_starts).all()


def test_prioritised_add_writes_the_largest_priority_from_the_write_slot():
    jbuf, tbuf = _prioritised_pair(4, seq=4, rows=2, capacity=32)
    jstate, tstate = jbuf.init(_jax_tree(_dummy())), tbuf.init(_torch_tree(_dummy()))
    rng = np.random.default_rng(3)
    for length, table_max in ((9, 7.5), (6, 0.5), (30, 3.0)):
        chunk = {k: v[:2] if not isinstance(v, tuple) else tuple(x[:2] for x in v)
                 for k, v in _chunk(rng, length).items()}
        table = rng.random((2, 8)).astype(np.float32)
        table[1, 2] = table_max
        jstate, tstate = _with_priorities(jstate, tstate, table)
        jstate = jbuf.add(jstate, _jax_tree(chunk))
        tstate = tbuf.add(tstate, _torch_tree(chunk))
        np.testing.assert_array_equal(n(tstate.priorities), np.asarray(jstate.priorities))
        assert float(tstate.priorities.max()) == max(table_max, 1.0)


def test_set_priorities_keeps_the_last_of_duplicate_indices_as_jax():
    jbuf, tbuf = _prioritised_pair(1, exponent=0.6)
    jstate, tstate = jbuf.init(_jax_tree(_dummy())), tbuf.init(_torch_tree(_dummy()))
    rng = np.random.default_rng(4)
    for _ in range(3):
        indices = np.stack([rng.integers(0, ROWS, 200), rng.integers(0, 5, 200)], -1).astype(
            np.int32)  # 200 draws over 15 (row, slot) pairs: many repeats
        values = rng.normal(size=200).astype(np.float32) * 3
        jstate = jbuf.set_priorities(jstate, jnp.asarray(indices), jnp.asarray(values))
        tstate = tbuf.set_priorities(tstate, t(indices).long(), t(values))
        np.testing.assert_allclose(n(tstate.priorities), np.asarray(jstate.priorities),
                                   rtol=1e-6, atol=0)
        # The last occurrence of each index, computed here in numpy.
        want = np.zeros((ROWS, CAPACITY), np.float32)
        for (r, s), v in zip(indices, values):
            want[r, s] = v
        written = np.zeros((ROWS, CAPACITY), bool)
        written[indices[:, 0], indices[:, 1]] = True
        np.testing.assert_allclose(n(tstate.priorities)[written],
                                   ((np.abs(want) + 1e-6) ** 0.6)[written], rtol=1e-6)
        assert duplicate_indices(t(indices).long()) == 200 - len(
            {tuple(i) for i in indices.tolist()})


# ------------------------------------------------- tests/test_buffers.py's oracles


def test_trajectory_buffer_sequences_are_time_contiguous():
    buf = make_trajectory_buffer(add_batch_size=2, sample_batch_size=16, sample_sequence_length=4,
                                 period=1, max_length_time_axis=32)
    state = buf.init({"t": torch.zeros(())})
    for chunk in range(2):  # global time indices 0..15 in chunks of 8
        steps = torch.arange(chunk * 8, (chunk + 1) * 8, dtype=torch.float32)
        state = buf.add(state, {"t": steps.expand(2, 8)})
    seqs = n(buf.sample(state, torch.Generator().manual_seed(0)).experience["t"])
    assert seqs.shape == (16, 4)
    np.testing.assert_allclose(np.diff(seqs, axis=1), 1.0)


def test_trajectory_buffer_wraparound_contiguity():
    buf = make_trajectory_buffer(add_batch_size=1, sample_batch_size=64, sample_sequence_length=4,
                                 period=1, max_length_time_axis=16)
    state = buf.init({"t": torch.zeros(())})
    for chunk in range(5):  # 40 steps into 16 slots
        state = buf.add(state, {"t": torch.arange(chunk * 8, (chunk + 1) * 8,
                                                  dtype=torch.float32)[None]})
    seqs = n(buf.sample(state, torch.Generator().manual_seed(0)).experience["t"])
    np.testing.assert_allclose(np.diff(seqs, axis=1), 1.0)  # never crosses the write head


def _one_row_prioritised(batch, capacity=8, exponent=1.0):
    return make_prioritised_trajectory_buffer(
        add_batch_size=1, sample_batch_size=batch, sample_sequence_length=1, period=1,
        max_length_time_axis=capacity, priority_exponent=exponent)


def test_prioritised_buffer_focuses_on_high_priority():
    buf = _one_row_prioritised(512)
    state = buf.add(buf.init({"t": torch.zeros(())}), {"t": torch.arange(8.0)[None]})
    state = state._replace(priorities=torch.zeros((1, 8)).index_fill_(1, torch.tensor([3]), 5.0))
    sample = buf.sample(state, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(n(sample.experience["t"]), 3.0)
    np.testing.assert_allclose(n(sample.probabilities), 1.0)
    # set_priorities moves the mass to slot 5.
    state = buf.set_priorities(state, torch.tensor([[0, 3], [0, 5]]), torch.tensor([0.0, 10.0]))
    sample = buf.sample(state, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(n(sample.experience["t"]), 5.0)
    np.testing.assert_array_equal(n(sample.indices[:, 1]), 5)


def test_prioritised_buffer_new_data_gets_max_priority():
    buf = _one_row_prioritised(8, exponent=0.6)
    state = buf.add(buf.init({"t": torch.zeros(())}), {"t": torch.arange(4.0)[None]})
    assert float(state.priorities[0, :4].min()) > 0.0
    assert float(state.priorities[0, 4:].max()) == 0.0  # unwritten slots unsampleable


def test_prioritised_buffer_alignment_after_wraparound():
    buf = _one_row_prioritised(256)
    state = buf.init({"t": torch.zeros(())})
    state = buf.add(state, {"t": torch.arange(8.0)[None]})
    state = buf.add(state, {"t": torch.arange(8.0, 12.0)[None]})  # 12 writes into 8 slots
    # Physical slot 6 still holds t = 6. Prioritise only it.
    state = state._replace(priorities=torch.zeros((1, 8)).index_fill_(1, torch.tensor([6]), 3.0))
    sample = buf.sample(state, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(n(sample.experience["t"]), 6.0)
    np.testing.assert_array_equal(n(sample.indices[:, 1]), 6)


def test_sample_guard_raises_typed_on_unfilled_buffers(sample_guard):
    item = make_item_buffer(max_length=16, min_length=8, sample_batch_size=4)
    state = item.init({"x": torch.zeros(())})
    with pytest.raises(EmptyBufferSampleError, match="unfilled item buffer"):
        item.sample(state, torch.Generator().manual_seed(0))
    state = item.add(state, {"x": torch.ones(8)})
    np.testing.assert_allclose(n(item.sample(state, torch.Generator()).experience["x"]), 1.0)
    # The warmup-less foot-gun: a first add that holds no full sequence.
    traj = make_trajectory_buffer(add_batch_size=2, sample_batch_size=4, sample_sequence_length=8,
                                  period=1, max_length_time_axis=32)
    tstate = traj.add(traj.init({"t": torch.zeros(())}), {"t": torch.ones((2, 4))})
    with pytest.raises(EmptyBufferSampleError, match="unfilled trajectory buffer"):
        traj.sample(tstate, torch.Generator())
    prio = make_prioritised_trajectory_buffer(add_batch_size=1, sample_batch_size=4,
                                              sample_sequence_length=8, period=1,
                                              max_length_time_axis=32)
    with pytest.raises(EmptyBufferSampleError, match="unfilled prioritised"):
        prio.sample(prio.init({"t": torch.zeros(())}), torch.Generator())


def test_sample_guard_off_keeps_the_silent_zero_fill():
    previous = set_sample_guard(False)
    try:
        traj = make_trajectory_buffer(add_batch_size=2, sample_batch_size=4,
                                      sample_sequence_length=8, period=1,
                                      max_length_time_axis=32)
        tstate = traj.add(traj.init({"t": torch.zeros(())}), {"t": torch.ones((2, 4))})
        seqs = n(traj.sample(tstate, torch.Generator().manual_seed(0)).experience["t"])
    finally:
        set_sample_guard(previous)
    assert seqs.shape == (4, 8) and (seqs[:, 4:] == 0.0).all()  # n_periods clamped to 1


def test_the_guard_reads_the_environment_variable_as_jax():
    # In a child process: reloading the buffer modules here would leave this
    # process's importers holding the old classes.
    code = (
        "import importlib, os, sys\n"
        "from stoix_tpu.buffers import buffers as j\n"
        "from stoix_tpu_torch.buffers import buffers as p\n"
        "for value in ('', '0', '1', 'yes'):\n"
        "    os.environ['STOIX_TPU_BUFFER_DEBUG'] = value\n"
        "    print(value, importlib.reload(p)._SAMPLE_GUARD, importlib.reload(j)._SAMPLE_GUARD)\n"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=120, check=True).stdout.split("\n")
    assert out[:4] == [" False False", "0 False False", "1 True True", "yes True True"]


def test_flat_buffer_is_the_item_buffer():
    flat = make_flat_buffer(max_length=10, min_length=1, sample_batch_size=4, add_batch_size=2)
    state = flat.add(flat.init({"x": torch.zeros(())}), {"x": torch.full((2,), 7.0)})
    np.testing.assert_allclose(n(flat.sample(state, torch.Generator()).experience["x"]), 7.0)


def test_require_first_add_samplable_matches_jax():
    for seq, rollout in ((16, 8), (8, 8), (4, 8)):
        raw = {"system": {"sample_sequence_length": seq, "rollout_length": rollout}}
        try:
            jcore.require_first_add_samplable(JaxConfig.from_dict(raw))
            refused = False
        except ValueError:
            refused = True
        if refused:
            with pytest.raises(ValueError, match="sample_sequence_length"):
                core.require_first_add_samplable(Config.from_dict(raw))
        else:
            core.require_first_add_samplable(Config.from_dict(raw))
        assert refused == (seq > rollout)


@pytest.mark.parametrize("envs,batch,size,minimum", [
    (128, 256, 100000, 16), (1024, 64, 50000, 32), (16, 64, 4096, 32), (8, 3, 10, 4)])
def test_trajectory_buffer_sizing_matches_jax(envs, batch, size, minimum):
    raw = {"arch": {"total_num_envs": envs, "update_batch_size": 1},
           "system": {"total_batch_size": batch, "total_buffer_size": size}}

    class Mesh:
        shape = {"data": 1}

    want = jcore.trajectory_buffer_sizing(JaxConfig.from_dict(raw), Mesh(), minimum)
    assert core.trajectory_buffer_sizing(Config.from_dict(raw), minimum) == want
    raw["arch"]["total_num_envs"] = 0
    with pytest.raises(ValueError, match="total_num_envs"):
        core.trajectory_buffer_sizing(Config.from_dict(raw), minimum)
