"""The value-based family's ops in the PyTorch port against the JAX package,
on the same numpy inputs, on the CPU.

- `EpsilonGreedy` and `Greedy` (ops/distributions.py), with and without an
  action mask, with a tie in the Q-values and epsilon as a float and as a
  tensor: the logits log(probs + 1e-12), normalised, within one float32 ulp
  (1.2e-7 relative: the log-sum-exp of a masked row parts by an ulp), the
  probabilities, their exp, within 3e-7 relative (exp rounds by an ulp or
  two otherwise in XLA than in PyTorch), the mode exact (both argmaxes take
  the first maximum).
- The three Q heads (networks/heads.py) in FeedForwardActor with flax params
  carried across by `load_flax_params`: 1e-5 relative (C51's [..., A, M] and
  QR-DQN's [..., N, A] reshapes in flax's order; the atoms and taus 1e-6).
- Every loss of ops/losses.py the family uses: 1e-6 relative.
  `categorical_l2_project` is vmapped row by row in JAX and two batched
  scatter-adds here, which may sum a target atom's shares in another order:
  1e-6 absolute on probabilities in [0, 1].
- `lambda_returns` and `q_lambda` under `scan` and `pallas` (B1's plain
  version on CPU tensors) with a tensor lambda, against `jax.jit` of the JAX
  functions: bitwise. XLA contracts the delta `r + g (1 - lambda) v` into one
  fused multiply-add inside `jit`, and the port states it (`fma_f32`).
- Clip + RAdam against `jax.jit` of `optax.chain(clip_by_global_norm,
  radam)` (jitted as the JAX learner runs it: eager JAX rounds b2**count
  otherwise, and rho = rho_inf - 2t b2^t / (1 - b2^t) cancels 1993 of its
  1999, so one ulp of b2^t moves r by 0.5%) over 10 steps that cross the
  rectification threshold (rho >= 5 from step 6): the params 1e-6 relative,
  each update within 1e-6 of its tensor's largest entry (momentum that
  cancels leaves entries near 0 whose relative error grows). The Polyak update against `jax.jit` of
  `optax.incremental_update`: bitwise (one fused multiply-add there too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu.networks import base as jbase, heads as jheads, inputs as jinputs
from stoix_tpu.networks import torso as jtorso
from stoix_tpu.ops import distributions as jdist
from stoix_tpu.ops import losses as jlosses
from stoix_tpu.ops import multistep as jmultistep
from stoix_tpu_torch.kernels import linear_recurrence as lr
from stoix_tpu_torch.networks import base as tbase, heads as theads, inputs as tinputs
from stoix_tpu_torch.networks import torso as ttorso
from stoix_tpu_torch.ops import distributions as tdist
from stoix_tpu_torch.ops import losses as tlosses
from stoix_tpu_torch.ops import multistep as tmultistep
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.training import ClipRAdam, apply_updates, incremental_update
from torch_parity import n, observations, t

RTOL = 1e-6


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=rtol, atol=atol)


# ----------------------------------------------------------------- distributions

Q_TIE = np.array([[1.0, 3.0, 3.0, -1.0], [0.5, 0.5, 0.5, 0.5], [-2.0, 0.0, 1.0, 2.0]],
                 np.float32)
MASK = np.array([[1, 0, 1, 1], [0, 1, 1, 0], [1, 1, 1, 0]], np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("epsilon", [0.0, 0.1, "tensor"])
def test_epsilon_greedy_matches_jax(masked, epsilon):
    mask = MASK if masked else None
    eps_np = np.float32(0.3) if epsilon == "tensor" else epsilon
    eps_t = torch.tensor(0.3) if epsilon == "tensor" else epsilon
    want = jdist.EpsilonGreedy(jnp.asarray(Q_TIE), jnp.asarray(eps_np),
                               None if mask is None else jnp.asarray(mask))
    got = tdist.EpsilonGreedy(t(Q_TIE), eps_t, None if mask is None else t(mask))
    _close(got.probs, want.probs, rtol=3e-7)
    _close(got.logits, want.logits, rtol=1.2e-7)
    assert np.array_equal(n(got.mode()), np.asarray(want.mode()))
    actions = t(np.array([1, 2, 0], np.int32))
    _close(got.log_prob(actions), want.log_prob(jnp.asarray(np.array([1, 2, 0]))), rtol=1.2e-7)
    # The tie: the first maximum, as jnp.argmax.
    assert n(got.mode())[0] == (2 if masked else 1) and n(got.mode())[1] == (1 if masked else 0)


@pytest.mark.parametrize("masked", [False, True])
def test_greedy_matches_jax(masked):
    mask = MASK if masked else None
    want = jdist.Greedy(jnp.asarray(Q_TIE), None if mask is None else jnp.asarray(mask))
    got = tdist.Greedy(t(Q_TIE), None if mask is None else t(mask))
    _close(got.probs, want.probs, rtol=3e-7)
    _close(got.logits, want.logits, rtol=1.2e-7)
    assert np.array_equal(n(got.mode()), np.asarray(want.mode()))


def test_epsilon_greedy_samples_from_its_generator():
    dist = tdist.EpsilonGreedy(t(np.tile(Q_TIE[:1], (4000, 1))), 0.4)
    draw = lambda seed: dist.sample(torch.Generator().manual_seed(seed))  # noqa: E731
    assert torch.equal(draw(3), draw(3))
    counts = np.bincount(n(draw(3)), minlength=4) / 4000
    np.testing.assert_allclose(counts, [0.1, 0.7, 0.1, 0.1], atol=0.03)


# ----------------------------------------------------------------- heads

OBS_DIM, ACTIONS = 5, 3
HEADS = {
    "dqn": (lambda: jheads.DiscreteQNetworkHead(action_dim=ACTIONS, epsilon=0.2),
            lambda: theads.DiscreteQNetworkHead(ACTIONS, 16, epsilon=0.2)),
    "c51": (lambda: jheads.DistributionalDiscreteQNetwork(action_dim=ACTIONS, num_atoms=7,
                                                          vmin=-2.0, vmax=3.0, epsilon=0.2),
            lambda: theads.DistributionalDiscreteQNetwork(ACTIONS, 16, num_atoms=7, vmin=-2.0,
                                                          vmax=3.0, epsilon=0.2)),
    "qr": (lambda: jheads.QuantileDiscreteQNetwork(action_dim=ACTIONS, num_quantiles=5,
                                                   epsilon=0.2),
           lambda: theads.QuantileDiscreteQNetwork(ACTIONS, 16, num_quantiles=5, epsilon=0.2)),
}


def paired_q_networks(kind, use_layer_norm=False, seed=0):
    """flax and torch Q-networks carrying identical params: (jax_net,
    jax_params, torch_net)."""
    jax_head, torch_head = HEADS[kind]
    jax_net = jbase.FeedForwardActor(
        action_head=jax_head(), input_layer=jinputs.ObservationInput(),
        torso=jtorso.MLPTorso((16, 16), use_layer_norm=use_layer_norm))
    dummy, _ = observations(0, 1, OBS_DIM, ACTIONS)
    params = jax.tree.map(np.asarray, jax_net.init(jax.random.PRNGKey(seed), dummy))
    torch_net = tbase.FeedForwardActor(
        torch_head(), ttorso.MLPTorso(OBS_DIM, (16, 16), use_layer_norm=use_layer_norm),
        tinputs.ObservationInput())
    load_flax_params(torch_net, params)
    return jax_net, params, torch_net


@pytest.mark.parametrize("kind", ["dqn", "c51", "qr"])
def test_q_heads_with_carried_params_match_flax(kind):
    jax_net, params, torch_net = paired_q_networks(kind, use_layer_norm=kind == "dqn")
    jobs, tobs = observations(1, 6, OBS_DIM, ACTIONS, mask=[1, 0, 1])
    want = jax_net.apply(params, jobs, 0.05)
    got = torch_net(tobs, 0.05)
    if kind == "dqn":
        want, got = (want,), (got,)
    _close(got[0].preferences, want[0].preferences, rtol=1e-5, atol=1e-6)
    _close(got[0].probs, want[0].probs, rtol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        assert tuple(g.shape) == tuple(np.shape(w))
        _close(g, w, rtol=1e-5, atol=1e-6)
    # The head's own epsilon when none is given.
    default = torch_net(tobs)
    default = default[0] if isinstance(default, tuple) else default
    assert float(default.epsilon) == pytest.approx(0.2)


# ----------------------------------------------------------------- losses

B, A, M, N = 32, 4, 11, 9


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return dict(
        q_tm1=f(B, A), q_t=f(B, A), q_sel=f(B, A), q_tm1_t=f(B, A),
        a=rng.integers(0, A, B).astype(np.int32), r=f(B),
        d=(0.99 * (rng.random(B) > 0.2)).astype(np.float32),
        logits_tm1=f(B, A, M), logits_t=f(B, A, M),
        dist_tm1=f(B, N, A), dist_t=f(B, N, A), dist_sel=f(B, N, A),
    )


@pytest.mark.parametrize("use_huber", [False, True])
def test_q_learning_and_double_q_learning_match_jax(use_huber):
    x = _loss_inputs(0)
    j, p = {k: jnp.asarray(v) for k, v in x.items()}, {k: t(v) for k, v in x.items()}
    _close(tlosses.q_learning(p["q_tm1"], p["a"], p["r"], p["d"], p["q_t"], use_huber, 0.7),
           jlosses.q_learning(j["q_tm1"], j["a"], j["r"], j["d"], j["q_t"], use_huber, 0.7))
    _close(tlosses.double_q_learning(p["q_tm1"], p["a"], p["r"], p["d"], p["q_t"], p["q_sel"],
                                     use_huber, 0.7),
           jlosses.double_q_learning(j["q_tm1"], j["a"], j["r"], j["d"], j["q_t"], j["q_sel"],
                                     use_huber, 0.7))
    _close(tlosses.huber_loss(p["r"] * 3, 0.7), jlosses.huber_loss(j["r"] * 3, 0.7))


def test_munchausen_q_learning_matches_jax():
    x = _loss_inputs(1)
    j, p = {k: jnp.asarray(v) for k, v in x.items()}, {k: t(v) for k, v in x.items()}
    args = ("q_tm1", "a", "r", "d", "q_t", "q_tm1_t")
    _close(tlosses.munchausen_q_learning(*(p[k] for k in args), 0.03, 0.9, -1e3),
           jlosses.munchausen_q_learning(*(j[k] for k in args), 0.03, 0.9, -1e3))


def test_categorical_l2_project_matches_jax():
    rng = np.random.default_rng(2)
    z_q = np.linspace(-3.0, 3.0, M).astype(np.float32)
    # Source atoms off the grid, on it (lower == upper) and past both ends.
    z_p = np.concatenate([rng.uniform(-4, 4, (B - 2, M)), np.tile(z_q, (2, 1))]).astype(
        np.float32)
    probs = rng.dirichlet(np.ones(M), B).astype(np.float32)
    got = tlosses.categorical_l2_project(t(z_p), t(probs), t(z_q))
    want = jlosses.categorical_l2_project(jnp.asarray(z_p), jnp.asarray(probs), jnp.asarray(z_q))
    _close(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(got).sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("vmin,vmax,atoms", [(0.0, 500.0, 16), (-7.0, 7.0, 24), (0.0, 10.0, 51)])
def test_categorical_l2_project_drops_a_share_past_the_support_as_jax(vmin, vmax, atoms):
    """ROADMAP C16: where the float32 grid step rounds down (16 atoms on
    [0, 500], 24 on [-7, 7]), a source atom clipped to vmax has its upper
    neighbour one past the support. JAX's `.at[].add` drops that share; the
    port dropped nothing and indexed past the array (an IndexError on the
    CPU, a device-side assert on the card, where 51 atoms on [0, 10] overflow
    too). It now drops the share as JAX does: 1e-6 absolute against the JAX
    projection run eagerly, whose grid step is a true division, as the
    port's (inside `jit` XLA rounds the step another way, as the test above
    does not see either)."""
    rng = np.random.default_rng(atoms)
    z_q = np.linspace(vmin, vmax, atoms).astype(np.float32)
    z_p = np.concatenate([rng.uniform(vmin, vmax * 1.2, (6, atoms)),
                          np.full((2, atoms), vmax * 2, np.float32)]).astype(np.float32)
    probs = rng.dirichlet(np.ones(atoms), 8).astype(np.float32)
    got = tlosses.categorical_l2_project(t(z_p), t(probs), t(z_q))
    want = jlosses.categorical_l2_project(jnp.asarray(z_p), jnp.asarray(probs), jnp.asarray(z_q))
    _close(got, want, rtol=0, atol=1e-6)
    assert (n(got).sum(-1) <= 1.0 + 1e-6).all()


def test_categorical_double_q_learning_matches_jax():
    x = _loss_inputs(3)
    atoms = np.linspace(0.0, 10.0, M).astype(np.float32)
    j, p = {k: jnp.asarray(v) for k, v in x.items()}, {k: t(v) for k, v in x.items()}
    _close(tlosses.categorical_double_q_learning(p["logits_tm1"], t(atoms), p["a"], p["r"] * 5,
                                                 p["d"], p["logits_t"], t(atoms), p["q_sel"]),
           jlosses.categorical_double_q_learning(j["logits_tm1"], jnp.asarray(atoms), j["a"],
                                                 j["r"] * 5, j["d"], j["logits_t"],
                                                 jnp.asarray(atoms), j["q_sel"]))


@pytest.mark.parametrize("huber", [0.0, 1.0])
def test_quantile_losses_match_jax(huber):
    x = _loss_inputs(4)
    tau = np.broadcast_to((np.arange(N) + 0.5) / N, (B, N)).astype(np.float32)
    j, p = {k: jnp.asarray(v) for k, v in x.items()}, {k: t(v) for k, v in x.items()}
    want_rows = jax.vmap(jlosses.quantile_regression_loss, in_axes=(0, 0, 0, None))(
        j["dist_tm1"][..., 0], jnp.asarray(tau), j["dist_t"][..., 1], huber)
    _close(tlosses.quantile_regression_loss(p["dist_tm1"][..., 0], t(tau), p["dist_t"][..., 1],
                                            huber), jnp.mean(want_rows))
    _close(tlosses.quantile_q_learning(p["dist_tm1"], t(tau), p["a"], p["r"], p["d"],
                                       p["dist_sel"], p["dist_t"], huber),
           jlosses.quantile_q_learning(j["dist_tm1"], jnp.asarray(tau), j["a"], j["r"], j["d"],
                                       j["dist_sel"], j["dist_t"], huber))


# ----------------------------------------------------------------- lambda returns


def _returns_inputs(seed, t_len=9, batch=130):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(t_len, batch)).astype(np.float32)
    discount = (0.99 * (rng.random((t_len, batch)) > 0.1)).astype(np.float32)
    q = rng.normal(size=(t_len, batch, 3)).astype(np.float32)
    lam = (0.95 * (rng.random((t_len, batch)) > 0.15)).astype(np.float32)  # truncations
    return r, discount, q, lam


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("batch_major", [False, True])
def test_lambda_returns_and_q_lambda_bitwise_jax(impl, batch_major):
    r, discount, q, lam = _returns_inputs(5)
    v = q.max(-1)
    if batch_major:
        r, discount, q, lam, v = (np.swapaxes(x, 0, 1).copy() for x in (r, discount, q, lam, v))
    want = jax.jit(lambda *a: jmultistep.lambda_returns(*a, batch_major=batch_major,
                                                        impl="scan"))(r, discount, v, lam)
    want_q = jax.jit(lambda *a: jmultistep.q_lambda(*a, batch_major=batch_major,
                                                    impl="scan"))(r, discount, q, lam)
    before = lr.KERNEL.launches
    got = tmultistep.lambda_returns(t(r), t(discount), t(v), t(lam), batch_major=batch_major,
                                    impl=impl)
    got_q = tmultistep.q_lambda(t(r), t(discount), t(q), t(lam), batch_major=batch_major,
                                impl=impl)
    assert lr.KERNEL.launches == before  # CPU tensors take the plain version
    assert np.array_equal(n(got), np.asarray(want))
    assert np.array_equal(n(got_q), np.asarray(want_q))
    # A scalar lambda broadcasts as JAX's does.
    want = jax.jit(lambda *a: jmultistep.lambda_returns(*a, 0.8, batch_major=batch_major,
                                                        impl="scan"))(r, discount, v)
    got = tmultistep.lambda_returns(t(r), t(discount), t(v), 0.8, batch_major=batch_major,
                                    impl=impl)
    assert np.array_equal(n(got), np.asarray(want))


def test_lambda_returns_delta_is_one_fused_multiply_add():
    # Two roundings miss jax.jit's result; the contracted delta does not.
    r, discount, q, lam = _returns_inputs(6, batch=512)
    v = q.max(-1)
    want = np.asarray(jax.jit(lambda *a: jmultistep.lambda_returns(*a, impl="scan"))(
        r, discount, v, lam))
    got = tmultistep.lambda_returns(t(r), t(discount), t(v), t(lam), impl="scan")
    assert np.array_equal(n(got), want)
    rt, dt, vt, lt = (t(x) for x in (r, discount, v, lam))
    two = tmultistep.scan_kernels.linear_recurrence_reverse(dt * lt, rt + dt * (1.0 - lt) * vt,
                                                            vt[-1], "scan")
    assert not np.array_equal(n(two), want)


# ----------------------------------------------------------------- optimizer and Polyak


def test_clip_radam_matches_optax_across_the_rectification_threshold():
    rng = np.random.default_rng(7)
    params = {"w": rng.normal(size=(6, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    optim = optax.chain(optax.clip_by_global_norm(0.5), optax.radam(5e-3))
    update = jax.jit(optim.update)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = optim.init(jparams)
    port = ClipRAdam(5e-3, 0.5)
    tparams = {k: t(v) for k, v in params.items()}
    tstate = port.init(tparams)
    for step in range(10):
        scale = 2.0 if step % 3 == 0 else 0.05  # clipped and unclipped steps
        grads = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        updates, jstate = update({k: jnp.asarray(g) for k, g in grads.items()}, jstate)
        jparams = optax.apply_updates(jparams, updates)
        tupdates, tstate = port.update({k: t(g) for k, g in grads.items()}, tstate)
        tparams = apply_updates(tparams, tupdates)
        for k in params:
            _close(tupdates[k], updates[k], rtol=0, atol=1e-6 * np.abs(updates[k]).max())
            _close(tparams[k], jparams[k], rtol=1e-6, atol=1e-7)
    assert tstate.count == 10


def test_polyak_update_bitwise_optax():
    rng = np.random.default_rng(8)
    new = {"w": rng.normal(size=(64, 32)).astype(np.float32)}
    old = {"w": rng.normal(size=(64, 32)).astype(np.float32)}
    for tau in (0.05, 0.005):
        want = jax.jit(lambda a, b: optax.incremental_update(a, b, tau))(new, old)
        got = incremental_update({k: t(v) for k, v in new.items()},
                                 {k: t(v) for k, v in old.items()}, tau)
        assert np.array_equal(n(got["w"]), np.asarray(want["w"]))


# ------------------------------------------------------- A12's ops: Deterministic, TD losses


def test_deterministic_distribution_matches_jax():
    loc = np.random.default_rng(0).normal(size=(6, 2)).astype(np.float32)
    jd, td = jdist.Deterministic(jnp.asarray(loc)), tdist.Deterministic(t(loc))
    for got, want in ((td.mode(), jd.mode()), (td.mean(), jd.mean()),
                      (td.sample(torch.Generator().manual_seed(0)),
                       jd.sample(seed=jax.random.PRNGKey(0))),
                      (td.log_prob(t(loc) + 1.0), jd.log_prob(jnp.asarray(loc) + 1.0)),
                      (td.entropy(), jd.entropy())):
        np.testing.assert_array_equal(n(got), np.asarray(want))
    assert n(td.entropy()).shape == (6,)
    assert n(tdist.Deterministic(torch.tensor(1.5)).log_prob(torch.tensor(0.0))).shape == ()


@pytest.mark.parametrize("use_huber", [False, True])
def test_td_learning_and_its_gradient_match_jax(use_huber):
    rng = np.random.default_rng(1)
    v_tm1, r, v_t = (rng.normal(size=32).astype(np.float32) * 3 for _ in range(3))
    d = (0.99 * (rng.random(32) > 0.2)).astype(np.float32)
    want, want_grad = jax.value_and_grad(
        lambda v: jlosses.td_learning(v, jnp.asarray(r), jnp.asarray(d), jnp.asarray(v_t),
                                      use_huber))(jnp.asarray(v_tm1))
    v = t(v_tm1).requires_grad_(True)
    got = tlosses.td_learning(v, t(r), t(d), t(v_t), use_huber)
    got.backward()
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(n(v.grad), np.asarray(want_grad), rtol=1e-6, atol=1e-8)


def test_categorical_td_learning_and_its_gradient_match_jax():
    rng = np.random.default_rng(2)
    logits_tm1, logits_t = (rng.normal(size=(32, 21)).astype(np.float32) for _ in range(2))
    atoms = np.linspace(-5.0, 5.0, 21).astype(np.float32)
    r = rng.normal(size=32).astype(np.float32)
    d = (0.9 * (rng.random(32) > 0.2)).astype(np.float32)
    want, want_grad = jax.jit(jax.value_and_grad(
        lambda x: jlosses.categorical_td_learning(x, jnp.asarray(atoms), jnp.asarray(r),
                                                  jnp.asarray(d), jnp.asarray(logits_t))))(
        jnp.asarray(logits_tm1))
    x = t(logits_tm1).requires_grad_(True)
    got = tlosses.categorical_td_learning(x, t(atoms), t(r), t(d), t(logits_t))
    got.backward()
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(n(x.grad), np.asarray(want_grad), rtol=0, atol=1e-7)
