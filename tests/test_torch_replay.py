"""The sharded replay of the PyTorch port (stoix_tpu_torch/replay, and the
OffPolicyPipeline of sebulba/core.py) against the JAX package's, on the CPU.

1. XLA's float32 sum and cumulative-sum orders (`xla_sum_f32`,
   `xla_cumsum_f32`) bitwise `jax.jit` of `jnp.sum` and `jnp.cumsum` on
   non-dyadic values from 1 to 100 000 elements.
2. On one shard the sharded core and the port's reference both equal JAX's
   `make_reference_replay` bitwise, uniform and prioritized, across ring
   wrap: the ring, the indices, rows and probabilities of the draw from
   JAX's uniforms. `set_priorities` (`(|p| + 1e-6) ** 0.6`) within 1e-6
   relative: XLA's float32 pow is a few ulps from the correctly rounded one
   the port takes; the draw after it starts from JAX's priorities.
3. On 2 and 4 in-process shards against JAX's `ShardedReplayService`
   (`make_sharded_replay` under `shard_map` on the virtual CPU mesh), fed
   JAX's uniforms: indices and rows exact, probabilities 1e-6 relative,
   uniform and prioritized; `set_priorities` across shard boundaries on 8
   shards; the partial-fill clip; uneven fills still partition the draw;
   the divisibility refusal; tests/test_replay.py's frequency oracle on 8
   shards; the ring wrap and the transport ledger.
4. The Anakin facade (`replay.impl: sharded`): on 2 gloo ranks against JAX's
   sharded item buffer on a 2-device mesh (rank 0's uniforms on both ranks,
   rows exact); one Anakin ff_dqn update through `build_buffer`'s facade
   against JAX's composition (the batch exact, the loss 1e-5 relative,
   params 1e-5 absolute); `replay.prioritized` refused with the JAX
   message, an unknown impl refused.
5. OffPolicyPipeline: tests/test_replay.py's four cases.
"""

import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stoix_tpu.base_types import OnlineAndTarget as JaxOnlineAndTarget
from stoix_tpu.parallel.mesh import shard_map
from stoix_tpu.replay import ShardedReplayService as JaxService
from stoix_tpu.replay import make_reference_replay as jax_reference
from stoix_tpu.replay.compat import make_sharded_item_buffer as jax_item_buffer
from stoix_tpu.systems.q_learning import ff_dqn as jax_dqn
from stoix_tpu_torch.base_types import OnlineAndTarget
from stoix_tpu_torch.envs import classic, wrappers
from stoix_tpu_torch.replay import (
    ShardedReplayService, make_reference_replay, make_sharded_replay, xla_cumsum_f32,
    xla_sum_f32,
)
from stoix_tpu_torch.sebulba.core import OffPolicyPipeline
from stoix_tpu_torch.systems import off_policy_core as core
from stoix_tpu_torch.systems.q_learning import ff_dqn
from stoix_tpu_torch.utils.tree import tree_map
from test_torch_q_family import (
    _assert_params, _batch, _configs, _jax_optim, _jax_update, _networks, _port_update,
)
from torch_parity import n, port_tree_as_jax, replay_state_to_jax, replay_state_to_port, t
from torch_ring_worker import spawn_ranks

ITEM = {"a": jnp.zeros((), jnp.int32), "d": jnp.zeros((), bool), "x": jnp.zeros((3,), jnp.float32)}
PORT_ITEM = {"a": torch.zeros((), dtype=torch.int32), "d": torch.zeros((), dtype=torch.bool),
             "x": torch.zeros(3)}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def chunk(n_items, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(0, 1000, n_items).astype(np.int32),
            "d": rng.random(n_items) < 0.3,
            "x": rng.normal(size=(n_items, 3)).astype(np.float32)}


def to_port(c):
    return {k: torch.from_numpy(np.array(v)) for k, v in c.items()}


def to_jax(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def split(c, shards):
    parts = {k: np.split(v, shards) for k, v in c.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(shards)]


def uniforms(key, batch):
    return torch.from_numpy(np.array(jax.random.uniform(key, (batch,))))


def priorities_like(seed, size):
    return np.random.default_rng(seed).gamma(0.7, 2.0, size).astype(np.float32)


def assert_sample(port, want, probability_rtol=0.0):
    """Port samples (a list of shard slices, or one) against a JAX sample."""
    port = port if isinstance(port, list) else [port]
    np.testing.assert_array_equal(np.concatenate([n(s.indices) for s in port]),
                                  np.asarray(want.indices))
    for k in ("a", "d", "x"):
        np.testing.assert_array_equal(np.concatenate([n(s.experience[k]) for s in port]),
                                      np.asarray(want.experience[k]), err_msg=k)
    got = np.concatenate([n(s.probabilities) for s in port])
    if probability_rtol:
        np.testing.assert_allclose(got, np.asarray(want.probabilities), rtol=probability_rtol)
    else:
        np.testing.assert_array_equal(got, np.asarray(want.probabilities))


# ----------------------------------------------------------------- XLA's orders


@pytest.mark.parametrize("size", [1, 17, 33, 100, 1000, 4097, 100000])
def test_xla_sum_and_cumsum_orders_bitwise_jax(size):
    x = (np.random.default_rng(size).random(size, dtype=np.float32) ** 0.6 + 1e-6).astype(
        np.float32)
    np.testing.assert_array_equal(n(xla_sum_f32(t(x))), np.asarray(jax.jit(jnp.sum)(x)))
    np.testing.assert_array_equal(n(xla_cumsum_f32(t(x))), np.asarray(jax.jit(jnp.cumsum)(x)))


# ----------------------------------------------------------------- one shard


@pytest.mark.parametrize("prioritized", [False, True])
def test_one_shard_bitwise_equals_jax_reference_across_wrap(prioritized):
    jref = jax_reference(64, 16, prioritized=prioritized)
    pref = make_reference_replay(64, 16, prioritized=prioritized)
    sharded = make_sharded_replay(64, 16, 1, prioritized=prioritized)
    jstate = jref.init(ITEM)
    rstate, sstates = pref.init(PORT_ITEM), [sharded.init(PORT_ITEM)]
    for i in range(11):  # 8 + ... + 18 = 143 items through 64 slots
        c = chunk(8 + i, i)
        jstate = jref.add(jstate, to_jax(c))
        rstate = pref.add(rstate, to_port(c))
        sstates = sharded.add(sstates, [to_port(c)])
        if prioritized and i % 3 == 2:
            drawn = jref.sample(jstate, jax.random.PRNGKey(100 + i))
            new = priorities_like(i, 16)
            jstate = jref.set_priorities(jstate, drawn.indices, jnp.asarray(new))
            rstate = pref.set_priorities(rstate, t(drawn.indices), t(new))
            sstates = sharded.set_priorities(sstates, [t(drawn.indices)], [t(new)])
            want = np.asarray(jstate.priorities)
            for got in (rstate.priorities, sstates[0].priorities):
                np.testing.assert_allclose(n(got), want, rtol=1e-6)
            # Go on from JAX's priorities: every later draw is then bitwise.
            rstate.priorities.copy_(t(want))
            sstates[0].priorities.copy_(t(want))
        for port in (rstate, sstates[0]):
            got = replay_state_to_jax([port], jstate)
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
                np.testing.assert_array_equal(a, np.asarray(b))
    key = jax.random.PRNGKey(3)
    want = jref.sample(jstate, key)
    assert_sample(pref.sample_from_uniforms(rstate, uniforms(key, 16)), want)
    assert_sample(sharded.sample_from_uniforms(sstates, uniforms(key, 16)), want)
    assert pref.can_sample(rstate) and sharded.can_sample(sstates)


def test_replay_state_moves_between_the_packages():
    jref = jax_reference(16, 4, prioritized=True)
    jstate = jref.add(jref.init(ITEM), to_jax(chunk(20, 0)))
    port = replay_state_to_port(jax.tree.map(np.asarray, jstate),
                                make_reference_replay(16, 4).init(PORT_ITEM))
    assert len(port) == 1 and (port[0].insert_pos, port[0].num_added) == (4, 20)
    back = replay_state_to_jax(port, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ----------------------------------------------------------------- K shards


def _mesh(devices, shards):
    return Mesh(np.asarray(devices[:shards]), ("data",))


def _put(mesh, tree):
    return jax.device_put(tree, NamedSharding(mesh, P("data")))


@pytest.mark.parametrize("prioritized", [False, True])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_core_matches_jax_shard_map(shards, prioritized, devices):
    capacity, batch = 32, 64
    mesh = _mesh(devices, shards)
    jsvc = JaxService(mesh, ITEM, capacity_per_shard=capacity, sample_batch_size=batch,
                      prioritized=prioritized)
    core = make_sharded_replay(capacity, batch, shards, prioritized=prioritized)
    states = [core.init(PORT_ITEM) for _ in range(shards)]
    for i in range(5):  # 12 a shard each add: the rings wrap at the third
        c = chunk(12 * shards, 10 + i)
        jsvc.add(_put(mesh, to_jax(c)))
        states = core.add(states, [to_port(s) for s in split(c, shards)])
        if prioritized and i in (2, 4):
            drawn = jsvc.sample(jax.random.PRNGKey(i))
            new = priorities_like(i, batch)
            jsvc.set_priorities(drawn.indices, _put(mesh, jnp.asarray(new)))
            states = core.set_priorities(states, list(t(np.asarray(drawn.indices)).chunk(shards)),
                                         list(t(new).chunk(shards)))
            want = np.asarray(jsvc.state.priorities)
            np.testing.assert_allclose(np.stack([n(s.priorities) for s in states]), want,
                                       rtol=1e-6)
            for s, w in zip(states, want):
                s.priorities.copy_(t(w))
    got = replay_state_to_jax(states, jax.tree.map(np.asarray, jsvc.state))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jsvc.state)):
        np.testing.assert_array_equal(a, np.asarray(b))
    key = jax.random.PRNGKey(7)
    assert_sample(core.sample_from_uniforms(states, uniforms(key, batch)), jsvc.sample(key),
                  probability_rtol=1e-6)
    assert core.occupancy(states) == jsvc.observe()["occupancy"] == [capacity] * shards


def test_set_priorities_across_shard_boundaries(devices):
    """tests/test_replay.py:84: all mass on boundary slots of different
    shards (the last slot of shard 0, the first of shard 1, the last of
    shard 7); every one of them, and only they, are drawn, as in JAX."""
    capacity, shards = 8, 8
    mesh = _mesh(devices, shards)
    jsvc = JaxService(mesh, ITEM, capacity_per_shard=capacity, sample_batch_size=64,
                      prioritized=True, priority_exponent=1.0)
    core = make_sharded_replay(capacity, 64, shards, prioritized=True, priority_exponent=1.0)
    c = chunk(64, 7)
    jsvc.add(_put(mesh, to_jax(c)))
    states = core.add([core.init(PORT_ITEM) for _ in range(shards)],
                      [to_port(s) for s in split(c, shards)])
    hot = [7, 8, 63]
    for idx, p in ((np.arange(64, dtype=np.int32), np.zeros(64, np.float32) - 1e-6),
                   (np.asarray((hot * 22)[:64], np.int32), np.full(64, 5.0, np.float32))):
        jsvc.set_priorities(_put(mesh, jnp.asarray(idx)), _put(mesh, jnp.asarray(p)))
        states = core.set_priorities(states, list(t(idx).chunk(shards)), list(t(p).chunk(shards)))
    np.testing.assert_allclose(np.stack([n(s.priorities) for s in states]),
                               np.asarray(jsvc.state.priorities), rtol=1e-6)
    key = jax.random.PRNGKey(1)
    drawn = core.sample_from_uniforms(states, uniforms(key, 64))
    got = set(np.concatenate([n(s.indices) for s in drawn]).tolist())
    assert got == set(hot), got
    assert_sample(drawn, jsvc.sample(key), probability_rtol=1e-6)


def test_sample_never_returns_unwritten_slot_on_partial_fill(devices):
    """tests/test_replay.py:250: 2 of 8 slots written a shard; the sliver at
    the top of a shard's ownership range still lands on a written slot."""
    mesh = _mesh(devices, 8)
    jsvc = JaxService(mesh, ITEM, capacity_per_shard=8, sample_batch_size=2048)
    core = make_sharded_replay(8, 2048, 8)
    c = chunk(16, 5)
    jsvc.add(_put(mesh, to_jax(c)))
    states = core.add([core.init(PORT_ITEM) for _ in range(8)],
                      [to_port(s) for s in split(c, 8)])
    key = jax.random.PRNGKey(9)
    drawn = core.sample_from_uniforms(states, uniforms(key, 2048))
    slots = np.concatenate([n(s.indices) for s in drawn]) % 8
    assert slots.max() <= 1
    assert all((n(s.probabilities) > 0).all() for s in drawn)
    assert_sample(drawn, jsvc.sample(key))


def test_uneven_fills_still_partition_the_draw():
    """Shards filled unevenly: every draw lands on a written slot of its
    owner, each shard owns its share of the mass, and uniform probabilities
    are 1 / (items held)."""
    core = make_sharded_replay(16, 4096, 4)
    fills = [3, 16, 0, 9]
    states = core.add([core.init(PORT_ITEM) for _ in range(4)],
                      [to_port(chunk(f, i)) for i, f in enumerate(fills)])
    drawn = core.sample(states, torch.Generator().manual_seed(0))
    idx = np.concatenate([n(s.indices) for s in drawn])
    owners, slots = idx // 16, idx % 16
    assert all(slots[owners == k].max() < f for k, f in enumerate(fills) if f)
    counts = np.bincount(owners, minlength=4) / idx.size
    np.testing.assert_allclose(counts, np.asarray(fills) / sum(fills), atol=0.03)
    np.testing.assert_array_equal(np.concatenate([n(s.probabilities) for s in drawn]),
                                  np.float32(1.0) / np.float32(sum(fills)))


def test_sample_batch_must_divide_over_shards():
    with pytest.raises(ValueError, match="divide evenly"):
        make_sharded_replay(capacity=8, sample_batch_size=9, num_shards=8)


def test_eight_shard_frequencies_match_priorities():
    """tests/test_replay.py:72 on the port's service: priority of global
    item g proportional to g; the draw's frequencies within 0.05 total
    variation of them, item 0 never drawn, probabilities by the GLOBAL mass."""
    n_items, batch = 64, 8192
    svc = ShardedReplayService(["cpu"] * 8, PORT_ITEM, capacity_per_shard=8,
                               sample_batch_size=batch, prioritized=True, priority_exponent=1.0)
    svc.add([to_port(s) for s in split(chunk(n_items, 0), 8)])
    idx = torch.arange(n_items, dtype=torch.int32).repeat(batch // n_items)
    svc.set_priorities(list(idx.chunk(8)), list(idx.float().chunk(8)))
    drawn = svc.sample(torch.Generator().manual_seed(0))
    g_idx = np.concatenate([n(s.indices) for s in drawn])
    counts = np.bincount(g_idx, minlength=n_items).astype(float)
    weights = np.arange(n_items, dtype=float)
    tv = 0.5 * np.abs(counts - weights / weights.sum() * batch).sum() / batch
    assert tv < 0.05, tv
    assert counts[0] == 0
    np.testing.assert_allclose(np.concatenate([n(s.probabilities) for s in drawn]),
                               g_idx / weights.sum(), rtol=1e-4)


def test_ring_wraps_and_the_ledger_counts_samples_not_experience():
    svc = ShardedReplayService(["cpu"] * 8, PORT_ITEM, capacity_per_shard=4, sample_batch_size=64)
    base = svc.stats()
    for i in range(3):  # 3 x 32 items into 8 x 4 slots: the rings wrap
        svc.add([to_port(s) for s in split({**chunk(32, i), "a": np.full(32, i, np.int32)}, 8)])
    assert svc.observe()["occupancy"] == [4] * 8
    drawn = svc.sample(torch.Generator().manual_seed(5))
    assert set(np.concatenate([n(s.experience["a"]) for s in drawn]).tolist()) <= {1, 2}
    stats = svc.stats()
    ingested = stats["ingested_bytes_total"] - base["ingested_bytes_total"]
    crossed = stats["sampled_bytes_crossed"] - base["sampled_bytes_crossed"]
    assert ingested == 3 * 32 * (4 + 1 + 3 * 4)  # a int32, d bool, x 3 float32 a row
    assert crossed == 64 * (4 + 1 + 3 * 4 + 8)  # the rows, an int32 index, a float32 prob
    assert svc.ring_bytes() == 8 * 4 * (4 + 1 + 3 * 4 + 4)


# ----------------------------------------------------------------- the facade


def _jax_facade_sample(devices, chunks, keys, capacity, batch, min_fill):
    """JAX's sharded item buffer on a 2-device mesh: each shard adds its
    chunks, then one draw with each shard's own key (shard 0's is used)."""
    mesh = _mesh(devices, 2)
    buf = jax_item_buffer(capacity, batch, 2, min_fill)

    def per_shard(items, key):
        state = buf.init(ITEM)
        for c in items:
            state = buf.add(state, jax.tree.map(lambda x: x[0], c))
        return buf.sample(state, key[0]).experience, buf.can_sample(state)[None]

    stacked = [jax.tree.map(lambda *xs: jnp.stack(xs), *(to_jax(c[r]) for r in range(2)))
               for c in chunks]
    run = jax.jit(shard_map(per_shard, mesh=mesh, in_specs=(P("data"), P("data")),
                            out_specs=(P("data"), P("data"))))
    return run(stacked, jnp.stack(keys))


def test_facade_on_two_gloo_ranks_matches_jax(devices, tmp_path):
    capacity, batch, min_fill = 16, 8, 24
    chunks = [[chunk(6, 20 + 2 * i + r) for r in range(2)] for i in range(4)]  # wraps at 16
    keys = [jax.random.PRNGKey(40), jax.random.PRNGKey(41)]
    rank_uniforms = [np.asarray(jax.random.uniform(k, (batch,))) for k in keys]
    job = ("facade", "sharded_item_buffer", dict(
        chunks=[[c[r] for c in chunks] for r in range(2)], uniforms=rank_uniforms,
        capacity=capacity, batch=batch, min_fill=min_fill, item={k: n(v) for k, v in
                                                                 PORT_ITEM.items()}))
    results = spawn_ranks([job], 2, tmp_path)
    want, can = _jax_facade_sample(devices, chunks, keys, capacity, batch, min_fill)
    for k in ("a", "d", "x"):
        got = np.concatenate([r["facade"]["experience"][k] for r in results])
        np.testing.assert_array_equal(got, np.asarray(want[k]), err_msg=k)
    assert [r["facade"]["can_sample"] for r in results] == [bool(c) for c in np.asarray(can)]
    assert all(r["facade"]["can_sample_before"] is False for r in results)


def _dqn_sharded_configs(extra=()):
    return _configs("dqn", ["system.replay.impl=sharded", "system.total_buffer_size=64",
                            "system.total_batch_size=32", *extra])


def test_anakin_dqn_update_through_the_facade_matches_jax():
    """One update of Anakin ff_dqn from a batch drawn through
    `build_buffer`'s facade (one process: one shard of 64 slots, a batch of
    32) against JAX's sharded item buffer and q_family composition, from the
    same ring (80 items: it wraps) and uniforms."""
    cfg, jcfg = _dqn_sharded_configs()
    cfg.system.action_dim = 3
    buffer, _ = core.build_buffer(wrappers.apply_core_wrappers(classic.CartPole()), cfg, "cpu",
                                  discrete_actions=True)
    jbatch, tbatch = _batch(11, size=80)
    jbuf = jax_item_buffer(64, 32, 1, 32)
    jstate = jbuf.add(jbuf.init(jax.tree.map(lambda x: x[0], jbatch)), jbatch)
    state = buffer.add(buffer.init(tree_map(lambda x: x[0], tbatch)), tbatch)
    assert buffer.can_sample(state)
    key = jax.random.PRNGKey(4)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jdrawn = jax.jit(shard_map(lambda s, k: jbuf.sample(s, k).experience, mesh=mesh,
                               in_specs=(P(), P()), out_specs=P(), check_vma=False))(jstate, key)
    tdrawn = buffer.sample_from_uniforms(state, uniforms(key, 32)).experience
    for a, b in zip(jax.tree.leaves(port_tree_as_jax(tdrawn, jdrawn)), jax.tree.leaves(jdrawn)):
        np.testing.assert_array_equal(a, np.asarray(b))

    jax_net, online, target, torch_net, port_online, port_target = _networks("dqn")
    optim = _jax_optim(jcfg)
    (params, _), loss = jax.jit(_jax_update(jax_dqn.dqn_loss, jax_net.apply, jcfg, optim))(
        JaxOnlineAndTarget(online, target), optim.init(online), jdrawn)
    update_fn, port_optim = _port_update("dqn", cfg, torch_net, ff_dqn.dqn_loss)
    tparams, _, info = update_fn([OnlineAndTarget(port_online, port_target)],
                                 [port_optim.init(port_online)], [tdrawn])
    np.testing.assert_allclose(n(info["q_loss"]), np.asarray(loss), rtol=1e-5)
    _assert_params(tparams[0].online, params.online, online)
    _assert_params(tparams[0].target, params.target, online)


def test_anakin_refusals():
    tenv = wrappers.apply_core_wrappers(classic.CartPole())
    cfg, _ = _dqn_sharded_configs(["system.replay.prioritized=true"])
    cfg.system.action_dim = 2
    with pytest.raises(ValueError, match="set_priorities"):
        core.build_buffer(tenv, cfg, "cpu", True)
    cfg, _ = _configs("dqn", ["system.replay.impl=hbm2"])
    with pytest.raises(ValueError, match="replay.impl"):
        core.build_buffer(tenv, cfg, "cpu", True)


# ----------------------------------------------------------------- OffPolicyPipeline


def test_offpolicy_pipeline_poll_never_lockstep():
    pipe = OffPolicyPipeline(num_actors=3)
    pipe.push(0, "a0")
    pipe.push(2, "c0")
    assert [a for a, _ in pipe.poll(timeout=0.0)] == [0, 2]
    assert pipe.poll(timeout=0.0) == []


def test_offpolicy_pipeline_poison_pill_raises_typed():
    from stoix_tpu_torch.resilience.errors import ComponentFailure

    pipe = OffPolicyPipeline(num_actors=2)
    pipe.fail(1, ComponentFailure("actor-1", "budget exhausted", None))
    with pytest.raises(ComponentFailure):
        pipe.poll(timeout=0.0)


def test_offpolicy_pipeline_starvation_names_stalest_actor():
    from stoix_tpu_torch.observability import ActorStarvationError

    pipe = OffPolicyPipeline(num_actors=2)
    pipe.heartbeats.beat("actor-0")  # actor-1 never beat: the stalest
    with pytest.raises(ActorStarvationError) as err:
        pipe.wait_for_data(timeout=0.05)
    assert err.value.actor_id == 1


def test_offpolicy_pipeline_backpressure_bounded():
    pipe = OffPolicyPipeline(num_actors=1, depth_per_actor=1)
    pipe.push(0, "p0")
    with pytest.raises(queue.Full):
        pipe.push(0, "p1", timeout=0.05)
    assert pipe.drain(timeout=0.05) == 1
