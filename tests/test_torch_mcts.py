"""The batched MCTS of the PyTorch port (stoix_tpu_torch/search/mcts.py)
against the JAX package's (stoix_tpu/search/mcts.py), on the CPU.

1. The tree: the port's B trees in lockstep against `jax.vmap` of
   `mcts._search_one` under `jax.jit`, on a random tabular MDP (B = 5,
   A = 4, 24 simulations, max_depth 24 and 3, so that orphan slots and
   depth-capped backups occur): every array of the tree bitwise, integers
   and floats (the multiply-adds XLA contracts are stated as fused ones;
   the softmax, pb_c and log are XLA's float32 algorithms). The tree test
   fails when the fused multiply-adds are taken apart.
2. pb_c for every visit count, and XLA's log, bitwise `jax.jit`'s.
3. `muzero_policy` and `gumbel_muzero_policy` fed the JAX package's draws
   (its Dirichlet, the categorical's Gumbel, the Gumbel root's), and
   `blend_root_action_noise` fed its uniforms: bitwise.
4. tests/test_mcts.py's three oracles (bandit, two-step chain, Gumbel
   bandit) on the port, with its own draws; the search reads nothing back
   from its tensors (no `item`, `tolist`, `bool` or `nonzero`); the
   Dirichlet draws at alpha 0.3 are rows that sum to 1, never NaN.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.search import mcts as jax_mcts
from stoix_tpu_torch.kernels import linear_recurrence
from stoix_tpu_torch.ops.multistep import xla_log_f32
from stoix_tpu_torch.search import mcts
from torch_parity import t

B, A, SIMULATIONS, STATES = 5, 4, 24, 7


def tabular(seed):
    """A random tabular MDP (transitions, rewards, discounts, the next
    state's prior logits and value) and a batch of roots."""
    rng = np.random.default_rng(seed)
    return dict(
        T=rng.integers(0, STATES, (STATES, A)).astype(np.int32),
        R=rng.normal(size=(STATES, A)).astype(np.float32),
        D=(rng.random((STATES, A)) > 0.2).astype(np.float32) * np.float32(0.99),
        L=rng.normal(size=(STATES, A)).astype(np.float32),
        V=rng.normal(size=STATES).astype(np.float32),
        logits=rng.normal(size=(B, A)).astype(np.float32),
        value=rng.normal(size=B).astype(np.float32),
        state=rng.integers(0, STATES, B).astype(np.int32),
    )


def _jax_recurrent_fn(j):
    def recurrent_fn(params, rng, action, embedding):  # one element, leading [1]
        s, a = embedding[0], action[0]
        nxt = j["T"][s, a]
        return jax_mcts.RecurrentFnOutput(
            reward=j["R"][s, a][None], discount=j["D"][s, a][None],
            prior_logits=j["L"][nxt][None], value=j["V"][nxt][None]), nxt[None]

    return recurrent_fn


def port_problem(tables):
    p = {k: t(v) for k, v in tables.items()}

    def recurrent_fn(params, noise, action, state):  # the batch
        s = state.long()
        nxt = p["T"][s, action].long()
        return mcts.RecurrentFnOutput(p["R"][s, action], p["D"][s, action], p["L"][nxt],
                                      p["V"][nxt]), nxt

    return mcts.RootFnOutput(p["logits"], p["value"], p["state"].long()), recurrent_fn


@functools.lru_cache(maxsize=None)
def _jitted_search(max_depth):
    """`jax.vmap` of `_search_one` under `jax.jit`, the tables an argument
    (one compile a depth)."""
    def search(j, keys):
        root = jax_mcts.RootFnOutput(j["logits"], j["value"], j["state"])
        return jax.vmap(lambda r, k: jax_mcts._search_one(
            None, k, r, _jax_recurrent_fn(j), SIMULATIONS, max_depth, 1.25, 19652.0))(root, keys)

    return jax.jit(search)


def jax_trees(tables, max_depth):
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    return _jitted_search(max_depth)({k: jnp.asarray(v) for k, v in tables.items()}, keys)[0]


def assert_trees_equal(got, want):
    for name in jax_mcts._Tree._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        g = g.numpy().astype(w.dtype)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("max_depth", [SIMULATIONS, 3])
def test_tree_matches_jitted_search_one_bitwise(seed, max_depth):
    tables = tabular(seed)
    want = jax_trees(tables, max_depth)
    root, recurrent_fn = port_problem(tables)
    got = mcts.search(None, root, recurrent_fn, SIMULATIONS, max_depth, 1.25, 19652.0)
    assert_trees_equal(got, want)
    visits, parent = np.asarray(want.visits), np.asarray(want.parent)
    orphans = int(((visits == 0) & (parent >= 0)).sum())
    if max_depth == 3:
        # Each orphan is a descent stopped by max_depth on an expanded child,
        # whose existing value was backed up again.
        assert orphans > 0
        assert int(visits[:, 0].min()) == SIMULATIONS + 1
    else:
        assert orphans == 0


def test_tree_needs_the_stated_fused_multiply_adds(monkeypatch):
    """Taken apart into a multiply and an add, the three multiply-adds give
    values JAX's jitted search does not."""
    tables = tabular(0)
    want = jax_trees(tables, SIMULATIONS)
    monkeypatch.setattr(mcts, "fma_f32", lambda a, b, c: a * b + c)
    root, recurrent_fn = port_problem(tables)
    got = mcts.search(None, root, recurrent_fn, SIMULATIONS, SIMULATIONS, 1.25, 19652.0)
    assert not np.array_equal(got.values.numpy(), np.asarray(want.values))


@pytest.mark.parametrize("simulations,base", [(24, 19652.0), (50, 19652.0), (16, 250.0)])
def test_pb_c_table_matches_jit_for_every_visit_count(simulations, base):
    counts = jnp.arange(simulations + 2, dtype=jnp.int32)
    want = jax.jit(lambda n: (1.25 + jnp.log((n + base + 1.0) / base),
                              jnp.sqrt(n.astype(jnp.float32))))(counts)
    pb_c, sqrt = mcts.visit_tables(simulations, 1.25, base, "cpu")
    np.testing.assert_array_equal(pb_c.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(sqrt.numpy(), np.asarray(want[1]))


def test_xla_log_is_bitwise_jits():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-9, 1.0, 20000), rng.uniform(0.5, 2.0, 20000),
                        np.exp(rng.uniform(-80, 80, 20000)), [0.0, np.inf, 1.0, 1e-9]]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(x))
    got = xla_log_f32(t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # ... where a correctly rounded log is not.
    positive = x > 0
    rounded = np.log(x[positive].astype(np.float64)).astype(np.float32)
    assert (rounded != want[positive]).sum() > 1000


@functools.lru_cache(maxsize=None)
def _jitted_policy(policy, option):
    """The JAX package's `muzero_policy` (`option`: max_depth) or
    `gumbel_muzero_policy` (`option`: considered actions) under `jax.jit`,
    the tables an argument."""
    def run(j, key):
        root = jax_mcts.RootFnOutput(j["logits"], j["value"], j["state"])
        if policy == "muzero":
            return jax_mcts.muzero_policy(None, key, root, _jax_recurrent_fn(j), SIMULATIONS,
                                          max_depth=option)
        return jax_mcts.gumbel_muzero_policy(None, key, root, _jax_recurrent_fn(j), SIMULATIONS,
                                             max_num_considered_actions=option)

    return jax.jit(run)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_depth", [SIMULATIONS, 3])
def test_muzero_policy_fed_jax_draws_is_bitwise(seed, max_depth):
    tables = tabular(seed)
    key = jax.random.PRNGKey(seed)
    want = _jitted_policy("muzero", max_depth)({k: jnp.asarray(v) for k, v in tables.items()},
                                               key)
    noise_key, _, action_key = jax.random.split(key, 3)
    noise = mcts.SearchNoise(
        t(jax.random.dirichlet(noise_key, jnp.full((A,), 0.3), shape=(B,))),
        t(jax.random.gumbel(action_key, (B, A))))
    port_root, port_fn = port_problem(tables)
    got = mcts.muzero_policy(None, noise, port_root, port_fn, SIMULATIONS, max_depth=max_depth)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("considered", [3, 16])
def test_gumbel_muzero_policy_fed_jax_draws_is_bitwise(seed, considered):
    tables = tabular(seed)
    key = jax.random.PRNGKey(seed)
    want = _jitted_policy("gumbel", considered)({k: jnp.asarray(v) for k, v in tables.items()},
                                                key)
    gumbel_key, _ = jax.random.split(key)
    noise = mcts.SearchNoise(None, t(jax.random.gumbel(gumbel_key, (B, A))))
    port_root, port_fn = port_problem(tables)
    got = mcts.gumbel_muzero_policy(None, noise, port_root, port_fn, SIMULATIONS,
                                    max_num_considered_actions=considered)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("fraction", [0.1, 0.5, 0.0])
def test_blend_root_action_noise_fed_jax_uniforms_is_bitwise(fraction):
    rng = np.random.default_rng(0)
    actions = rng.uniform(-2, 2, (6, 8, 3)).astype(np.float32)
    lo, hi = np.array([-2.0, -1.0, 0.0], np.float32), np.array([2.0, 3.0, 0.5], np.float32)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda k, a: jax_mcts.blend_root_action_noise(k, a, fraction, lo, hi))(
        key, jnp.asarray(actions))
    uniform = jax.random.uniform(key, actions.shape, jnp.float32)
    got = mcts.blend_root_action_noise(t(uniform), t(actions), fraction, lo, hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------ tests/test_mcts.py's oracles


def bandit_recurrent_fn(best_action: int, num_actions: int = 4):
    """One-step bandit: reward 1 for best_action, else 0; the episode ends."""

    def recurrent_fn(params, noise, action, embedding):
        reward = (action == best_action).to(torch.float32)
        return mcts.RecurrentFnOutput(reward, torch.zeros_like(reward),
                                      torch.zeros(action.shape + (num_actions,)),
                                      torch.zeros_like(reward)), embedding

    return recurrent_fn


def _generator(seed):
    generator = torch.Generator()
    generator.manual_seed(seed)
    return generator


def test_muzero_policy_finds_best_bandit_arm():
    batch, actions = 4, 4
    root = mcts.RootFnOutput(torch.zeros((batch, actions)), torch.zeros((batch,)),
                             {"s": torch.zeros((batch, 1))})
    out = mcts.muzero_policy(None, mcts.draw_noise(_generator(0), batch, actions), root,
                             bandit_recurrent_fn(2), num_simulations=48, dirichlet_fraction=0.0,
                             temperature=0.1)
    assert out.action.shape == (batch,)
    np.testing.assert_array_equal(out.action.numpy(), 2)
    assert float(out.action_weights[:, 2].min()) > 0.5
    assert float(out.search_value.min()) > 0.3


def test_muzero_policy_two_step_credit():
    actions = 2

    def recurrent_fn(params, noise, action, embedding):
        pos = embedding["pos"]
        new_pos = torch.where(action == 1, pos + 1, pos)
        reward = (new_pos >= 2).to(torch.float32) * (pos < 2)
        return mcts.RecurrentFnOutput(
            reward, torch.where(new_pos >= 2, 0.0, 1.0), torch.zeros(action.shape + (actions,)),
            torch.zeros_like(reward)), {"pos": new_pos}

    root = mcts.RootFnOutput(torch.zeros((2, actions)), torch.zeros((2,)),
                             {"pos": torch.zeros((2,), dtype=torch.int32)})
    out = mcts.muzero_policy(None, mcts.draw_noise(_generator(1), 2, actions), root,
                             recurrent_fn, num_simulations=64, dirichlet_fraction=0.0,
                             temperature=0.05)
    np.testing.assert_array_equal(out.action.numpy(), 1)


def test_gumbel_muzero_policy_bandit():
    batch, actions = 3, 4
    root = mcts.RootFnOutput(torch.zeros((batch, actions)), torch.zeros((batch,)),
                             {"s": torch.zeros((batch, 1))})
    out = mcts.gumbel_muzero_policy(None, mcts.draw_noise(_generator(2), batch, actions), root,
                                    bandit_recurrent_fn(1), num_simulations=48)
    np.testing.assert_array_equal(out.action.numpy(), 1)
    assert float(out.action_weights[:, 1].min()) > 0.5


def test_search_reads_nothing_back_from_its_tensors(monkeypatch):
    """The search launches the same ops whatever the data: no tensor is
    read on the host inside it (on the card each read would wait for it)."""
    tables = tabular(0)
    root, recurrent_fn = port_problem(tables)
    noise = mcts.draw_noise(_generator(0), B, A, 0.25)

    def refuse(*args, **kwargs):
        raise AssertionError("a host read inside the search")

    for name in ("item", "tolist", "__bool__", "nonzero", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = mcts.muzero_policy(None, noise, root, recurrent_fn, SIMULATIONS, max_depth=3)
    gumbel = mcts.gumbel_muzero_policy(None, noise, root, recurrent_fn, SIMULATIONS)
    monkeypatch.undo()
    assert out.action.shape == gumbel.action.shape == (B,)


def test_dirichlet_rows_at_alpha_0_3_sum_to_one_and_are_finite():
    noise = mcts.draw_noise(_generator(5), 20000, 4, 0.25, 0.3)
    assert noise.dirichlet.dtype == torch.float32
    assert bool(torch.isfinite(noise.dirichlet).all())
    np.testing.assert_allclose(noise.dirichlet.sum(-1).numpy(), 1.0, atol=1e-6)
    # Near-zero entries are common at alpha 0.3 (a float32 gamma row could
    # underflow to all zeros).
    assert float(noise.dirichlet.min()) < 1e-12
    assert noise.gumbel.shape == (20000, 4) and bool(torch.isfinite(noise.gumbel).all())
    assert mcts.draw_noise(_generator(5), 3, 4).dirichlet is None


def test_fused_multiply_add_reference_is_single_rounding():
    """The tree's fused multiply-adds round once (against float64)."""
    rng = np.random.default_rng(1)
    a, b, c = (rng.normal(size=4096).astype(np.float32) for _ in range(3))
    want = (a.astype(np.float64) * b + c).astype(np.float32)
    np.testing.assert_array_equal(linear_recurrence.fma_f32(t(a), t(b), t(c)).numpy(), want)
