"""Networks of the PyTorch port against the JAX package's flax modules, with
the SAME parameters carried across by utils/params.py::load_flax_params.

Tolerance: 1e-5 relative (1e-6 absolute floor) in float32 — the matmuls and
silu reduce and round in another order than XLA's. bf16 compute is bitwise:
the port rounds where flax rounds. The continuous heads' log-probs,
entropies and modes: 1e-5 relative, with an absolute floor of 1e-5 of each
output's largest entry (a Beta log-density is a difference of lgammas).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu_torch.networks import heads, inputs, torso
from stoix_tpu_torch.networks.base import FeedForwardActor, FeedForwardCritic
from stoix_tpu_torch.networks.utils import parse_activation_fn
from stoix_tpu_torch.utils.params import load_flax_params
from torch_parity import n, observations, paired_networks, to_flax_params

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("layer_norm", [False, True])
def test_actor_logits_and_critic_values_match_flax(layer_norm):
    ja, jap, jc, jcp, ta, tc = paired_networks(6, 3, (32, 32), use_layer_norm=layer_norm)
    jobs, tobs = observations(1, 8, 6, 3)
    want_logits = np.asarray(ja.apply(jap, jobs).logits)
    want_values = np.asarray(jc.apply(jcp, jobs))
    with torch.no_grad():
        got_logits = n(ta(tobs).logits)
        got_values = n(tc(tobs))
    assert got_values.shape == (8,)
    np.testing.assert_allclose(got_logits, want_logits, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_values, want_values, rtol=RTOL, atol=ATOL)


def test_actor_respects_action_mask_like_flax():
    mask = [1.0, 0.0, 1.0]
    ja, jap, _, _, ta, _ = paired_networks(6, 3, (32, 32))
    jobs, tobs = observations(2, 64, 6, 3, mask=mask)
    want = ja.apply(jap, jobs)
    with torch.no_grad():
        got = ta(tobs)
    legal = np.array(mask, bool)
    np.testing.assert_allclose(
        n(got.logits)[:, legal], np.asarray(want.logits)[:, legal], rtol=RTOL, atol=ATOL
    )
    assert np.all(n(got.probs)[:, ~legal] == 0.0)
    samples = got.sample(torch.Generator().manual_seed(0))
    assert not np.any(n(samples) == 1)


def _bf16_torsos(seed, use_layer_norm):
    import jax

    from stoix_tpu.networks import torso as jtorso

    jnet = jtorso.MLPTorso((32, 32), compute_dtype="bfloat16", use_layer_norm=use_layer_norm)
    x = np.random.default_rng(seed).normal(size=(64, 6)).astype(np.float32)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    tnet = load_flax_params(
        torso.MLPTorso(6, (32, 32), compute_dtype="bfloat16", use_layer_norm=use_layer_norm),
        params,
    )
    return jnet, params, tnet, x


def _assert_bf16_torso_bitwise(seed, use_layer_norm):
    """bf16 compute rounds where flax rounds (input, kernel and bias cast to
    bf16, the product rounded before the bias add, LayerNorm statistics in
    float32, silu as XLA expands it op by op): bitwise against flax's apply.
    Under `jit` XLA drops the last rounding before the float32 cast (excess
    precision inside a fusion); rounded once to bf16, that output is bitwise too."""
    import jax

    jnet, params, tnet, x = _bf16_torsos(seed, use_layer_norm)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    np.testing.assert_array_equal(n(got), np.asarray(jnet.apply(params, jnp.asarray(x))))
    jitted = jax.jit(jnet.apply)(params, jnp.asarray(x)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(n(got), np.asarray(jitted.astype(jnp.float32)))


def test_bf16_compute_dtype_matches_flax():
    for seed in range(3):
        _assert_bf16_torso_bitwise(seed, use_layer_norm=False)


def test_bf16_compute_dtype_with_layer_norm_matches_flax():
    for seed in range(3):
        _assert_bf16_torso_bitwise(seed, use_layer_norm=True)


def test_param_carry_across_round_trips_and_fails_loudly():
    ja, jap, _, _, ta, _ = paired_networks(6, 3, (32, 32))
    back = to_flax_params(dict(ta.named_parameters()), jap)
    for path in (("torso", "Dense_0", "kernel"), ("action_head", "Dense_0", "bias")):
        want, got = jap["params"], back["params"]
        for key in path:
            want, got = want[key], got[key]
        np.testing.assert_array_equal(got, want)

    missing = {"params": {"torso": dict(jap["params"]["torso"])}}
    with pytest.raises(ValueError, match="missing flax parameter for action_head"):
        load_flax_params(ta, missing)
    extra = {"params": {**jap["params"], "torso": {**jap["params"]["torso"],
                                                    "Dense_5": {"kernel": np.zeros((32, 32)),
                                                                "bias": np.zeros(32)}}}}
    with pytest.raises(ValueError, match="extra flax parameter torso.dense.5"):
        load_flax_params(ta, extra)
    wrong = {"params": {**jap["params"], "action_head": {"Dense_0": {
        "kernel": np.zeros((32, 5), np.float32), "bias": np.zeros(5, np.float32)}}}}
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(ta, wrong)


def test_inits_follow_flax_scales():
    gen = torch.Generator().manual_seed(0)
    t_net = torso.MLPTorso(4, (64, 64), generator=gen)
    head = heads.CategoricalHead(3, 64, generator=gen)
    critic = heads.ScalarCriticHead(64, generator=gen)
    # Orthogonal rows scaled by the gain; zero biases.
    for layer, gain in ((t_net.dense[1], 2**0.5), (head.dense[0], 0.01), (critic.dense[0], 1.0)):
        w = layer.weight.detach()
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(n(gram), gain**2 * np.eye(gram.shape[0]), atol=1e-5)
        assert torch.count_nonzero(layer.bias) == 0


def test_feedforward_modules_compose_like_flax():
    actor = FeedForwardActor(
        heads.CategoricalHead(3, 8), torso.MLPTorso(5, (8,)), inputs.ObservationInput()
    )
    critic = FeedForwardCritic(
        heads.ScalarCriticHead(8), torso.MLPTorso(5, (8,)), inputs.ObservationInput()
    )
    _, tobs = observations(4, 7, 5, 3)
    with torch.no_grad():
        assert actor(tobs).logits.shape == (7, 3)
        assert critic(tobs).shape == (7,)
        assert actor.torso(tobs.agent_view).shape == (7, 8)
    with pytest.raises(ValueError, match="Unknown activation"):
        parse_activation_fn("nope")


# ------------------------------------------------------- continuous heads and RNN cells

CONTINUOUS_HEADS = {  # name -> head kwargs
    "NormalAffineTanhDistributionHead": dict(minimum=[-2.0, -1.0, 0.0], maximum=[2.0, 3.0, 0.5]),
    "BetaDistributionHead": dict(minimum=-2.0, maximum=2.0),
    "MultivariateNormalDiagHead": dict(init_scale=0.5),
}


@pytest.mark.parametrize("name", list(CONTINUOUS_HEADS))
def test_continuous_heads_with_carried_flax_params_match_flax(name):
    """Dense_0 (the loc, or alpha) and Dense_1 (the scale, or beta) carried
    across; the distributions' log-probs, entropies and modes agree, with
    embeddings large enough to put softplus past 20 and tanh at its bounds."""
    import jax

    from stoix_tpu.networks import heads as jheads

    kwargs = CONTINUOUS_HEADS[name]
    jhead = getattr(jheads, name)(3, **kwargs)
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(16, 8)).astype(np.float32)
    params = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(1), jnp.asarray(emb)))
    params = jax.tree.map(lambda x: x * 300.0, params)  # |pre-activations| past 20
    thead = getattr(heads, name)(3, 8, **kwargs)
    load_flax_params(thead, params)
    assert sorted(n for n, _ in thead.named_parameters()) == [
        "dense.0.bias", "dense.0.weight", "dense.1.bias", "dense.1.weight"]
    jdist, tdist = jhead.apply(params, jnp.asarray(emb)), thead(torch.from_numpy(emb))
    value = np.clip(np.asarray(jdist.mode()) + rng.normal(scale=0.1, size=(16, 3)),
                    -1.9, 1.9).astype(np.float32)
    value = np.clip(value, np.asarray(kwargs.get("minimum", -1.9)) + 0.01,
                    np.asarray(kwargs.get("maximum", 1.9)) - 0.01).astype(np.float32)
    for got, want in ((tdist.mode(), jdist.mode()), (tdist.entropy(), jdist.entropy()),
                      (tdist.log_prob(torch.from_numpy(value)), jdist.log_prob(jnp.asarray(value)))):
        want = np.asarray(want)
        np.testing.assert_allclose(n(got), want, rtol=RTOL, atol=1e-5 * np.abs(want).max())
    back = to_flax_params(dict(thead.named_parameters()), params)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, w), back, params)


# flax's cells and their gates: the GRU's and the MGU's and the simple
# cell's hidden state is one tensor, the two LSTMs' a (c, h) pair.
CELLS = {
    "gru": ("GRUCell", ("hn", "hr", "hz", "in", "ir", "iz")),
    "lstm": ("LSTMCell", ("hf", "hg", "hi", "ho", "if", "ig", "ii", "io")),
    "optimised_lstm": ("OptimizedLSTMCell", ("hf", "hg", "hi", "ho", "if", "ig", "ii", "io")),
    "mgu": ("MGUCell", ("hf", "hn", "if", "in")),
    "simple": ("SimpleCell", ("h", "i")),
}


@pytest.mark.parametrize("cell_type", list(CELLS))
def test_rnn_cells_carry_flax_params_one_to_one(cell_type):
    """flax's GRUCell (ir, iz, in with a bias; hr, hz without; hn with),
    LSTMCell and OptimizedLSTMCell (ii, if, ig, io without a bias; hi, hf,
    hg, ho with), MGUCell (if, in with a bias; hf without; hn with) and
    SimpleCell (i with a bias; h without) map gate for gate onto the port's
    cells: one step from a random carry 1e-5 relative; a missing or
    misshapen gate raises."""
    import flax.linen as fnn
    import jax

    from stoix_tpu_torch.networks.utils import RNN_CELLS

    flax_name, gates = CELLS[cell_type]
    flax_cell = getattr(fnn, flax_name)(features=6)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    carry = flax_cell.initialize_carry(jax.random.PRNGKey(0), x.shape)
    carry = jax.tree.map(lambda c: jnp.asarray(rng.normal(size=c.shape).astype(np.float32)), carry)
    params = jax.tree.map(np.asarray, flax_cell.init(jax.random.PRNGKey(1), carry, jnp.asarray(x)))
    cell = RNN_CELLS[cell_type](4, 6)
    load_flax_params(cell, params)
    (want_carry, want_out) = flax_cell.apply(params, carry, jnp.asarray(x))
    got_carry, got_out = cell(jax.tree.map(lambda c: torch.tensor(np.asarray(c)), carry),
                              torch.from_numpy(x))
    np.testing.assert_allclose(n(got_out), np.asarray(want_out), rtol=RTOL, atol=ATOL)
    for got, want in zip(jax.tree.leaves(got_carry), jax.tree.leaves(want_carry)):
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert sorted(params["params"]) == list(gates)
    # A fresh port carry has flax's structure and zeros.
    fresh = RNN_CELLS[cell_type].initialize_carry(6, (5,))
    for got, want in zip(jax.tree.leaves(fresh), jax.tree.leaves(
            flax_cell.initialize_carry(jax.random.PRNGKey(0), x.shape))):
        np.testing.assert_array_equal(n(got), np.asarray(want))
    first = gates[0]
    missing = {"params": {k: v for k, v in params["params"].items() if k != first}}
    with pytest.raises(ValueError, match=f"missing flax parameter for {first}"):
        load_flax_params(cell, missing)
    wrong = {"params": {**params["params"], first: {
        k: np.zeros((7,) + v.shape[1:], np.float32) for k, v in params["params"][first].items()}}}
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(cell, wrong)


def test_rnn_cell_registry_refuses_the_unported_cells_naming_the_key():
    """Every cell of the JAX package's registry is ported (ROADMAP A9b); an
    unknown name still raises, naming the registry."""
    from stoix_tpu.networks.utils import RNN_CELLS as JAX_RNN_CELLS
    from stoix_tpu_torch.networks.utils import RNN_CELLS, parse_rnn_cell

    assert sorted(RNN_CELLS) == sorted(JAX_RNN_CELLS) == sorted(CELLS)
    for name in ("optimised_lstm", "mgu", "simple"):
        assert parse_rnn_cell(name) is RNN_CELLS[name]
    with pytest.raises(ValueError, match="Unknown RNN cell"):
        parse_rnn_cell("transformer")


@pytest.mark.parametrize("shape", [(5, 8), (3, 4, 16), (2, 1)])
def test_normalise_activation_matches_flax_standardize(shape):
    """ACTIVATIONS["normalise"] is flax's `standardize` (the variance
    mean(x^2) - mean^2 clipped at 0, then rsqrt): 1e-5 relative, 1e-6 floor;
    a constant row (variance 0) stays finite as in flax."""
    import flax.linen as fnn

    from stoix_tpu_torch.networks.utils import parse_activation_fn

    x = (np.random.default_rng(3).normal(size=shape) * 4 + 1).astype(np.float32)
    x[0] = 2.5
    got = parse_activation_fn("normalise")(torch.from_numpy(x))
    want = np.asarray(fnn.standardize(jnp.asarray(x)))
    np.testing.assert_allclose(n(got), want, rtol=RTOL, atol=ATOL)
    assert np.isfinite(n(got)).all()


# ------------------------------------------------------- the continuous actor-critics' networks


def _q_critic_pair(head="ScalarCriticHead", num=2, obs_dim=5, action_dim=2, seed=3, **head_kwargs):
    """flax's MultiNetwork of `num` Q(s, a) critics (or one critic, num=0)
    and the port's, carrying the same params: (jax net, params, port net)."""
    import jax

    from stoix_tpu.networks import base as jbase, heads as jheads, inputs as jinputs
    from stoix_tpu.networks import torso as jtorso
    from stoix_tpu_torch.networks.base import MultiNetwork

    def jcritic():
        return jbase.FeedForwardCritic(
            critic_head=getattr(jheads, head)(**head_kwargs),
            torso=jtorso.MLPTorso((32, 32), activation="relu"),
            input_layer=jinputs.EmbeddingActionInput())

    def tcritic():
        return FeedForwardCritic(getattr(heads, head)(input_dim=32, **head_kwargs),
                                 torso.MLPTorso(obs_dim + action_dim, (32, 32), activation="relu"),
                                 inputs.EmbeddingActionInput())

    jnet = jbase.MultiNetwork([jcritic() for _ in range(num)]) if num else jcritic()
    tnet = MultiNetwork([tcritic() for _ in range(num)]) if num else tcritic()
    jobs, _ = observations(0, 1, obs_dim, 1)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(seed), jobs,
                                                jnp.zeros((1, action_dim))))
    load_flax_params(tnet, params)
    return jnet, params, tnet


def test_twin_q_critics_on_embedding_action_input_match_flax():
    """MultiNetwork of two FeedForwardCritics on EmbeddingActionInput: flax's
    networks_0 and networks_1 carried across; Q(s, a) [B, 2] stacked on the
    last axis; the params map back to flax's tree exactly."""
    import jax

    jnet, params, tnet = _q_critic_pair()
    assert sorted({name.split(".")[1] for name, _ in tnet.named_parameters()}) == ["0", "1"]
    jobs, tobs = observations(4, 16, 5, 1)
    action = np.random.default_rng(5).uniform(-2, 2, size=(16, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)(params, jobs, jnp.asarray(action)))
    with torch.no_grad():
        got = n(tnet(tobs, torch.from_numpy(action)))
    assert got.shape == want.shape == (16, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    back = to_flax_params(dict(tnet.named_parameters()), params)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, w), back, params)


def test_load_flax_params_refuses_a_twin_critic_tree_that_does_not_fit():
    import copy

    _, params, tnet = _q_critic_pair()
    missing = copy.deepcopy(params)
    del missing["params"]["networks_1"]["critic_head"]
    with pytest.raises(ValueError, match="missing flax parameter for networks.1.critic_head"):
        load_flax_params(tnet, missing)
    extra = copy.deepcopy(params)
    extra["params"]["networks_2"] = copy.deepcopy(extra["params"]["networks_0"])
    with pytest.raises(ValueError, match="extra flax parameter networks.2"):
        load_flax_params(tnet, extra)
    wrong = copy.deepcopy(params)
    wrong["params"]["networks_0"]["torso"]["Dense_0"]["kernel"] = np.zeros((6, 32), np.float32)
    with pytest.raises(ValueError, match="networks.0.torso.dense.0.weight"):
        load_flax_params(tnet, wrong)


@pytest.mark.parametrize("bounds", [(-2.0, 2.0), (-0.7, 1.9)])
def test_deterministic_head_matches_flax(bounds):
    """tanh(Dense_0) . half_width + mid, the host floats as flax forms them,
    against the jitted flax head; log_prob and entropy zeros over [B]."""
    import jax

    from stoix_tpu.networks import heads as jheads

    lo, hi = bounds
    jhead = jheads.DeterministicHead(3, minimum=lo, maximum=hi)
    emb = np.random.default_rng(7).normal(size=(16, 8)).astype(np.float32)
    params = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(2), jnp.asarray(emb)))
    params = jax.tree.map(lambda x: x * 100.0, params)  # tanh near its bounds too
    thead = load_flax_params(heads.DeterministicHead(3, 8, minimum=lo, maximum=hi), params)
    want = jax.jit(lambda p, x: jhead.apply(p, x).mode())(params, jnp.asarray(emb))
    tdist = thead(torch.from_numpy(emb))
    for got in (tdist.mode(), tdist.mean(), tdist.sample(torch.Generator().manual_seed(0))):
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert np.abs(n(tdist.mode())).max() > 0.9 * max(abs(lo), abs(hi))
    assert n(tdist.log_prob(tdist.mode())).tolist() == [0.0] * 16
    assert n(tdist.entropy()).shape == (16,)


def test_distributional_continuous_q_head_matches_flax():
    """D4PG's critic head (51 atoms on [-100, 100]) with carried params:
    expected Q and logits against the jitted flax head; the support within
    one float32 ulp of 100 of `jnp.linspace` eager and jitted (ROADMAP C17:
    XLA's support is not correctly rounded, eager and jitted apart on some
    supports, while `torch.linspace` gives every multiple of 4 exactly)."""
    import jax

    jnet, params, tnet = _q_critic_pair("DistributionalContinuousQNetwork", num=0, num_atoms=51,
                                        vmin=-100.0, vmax=100.0)
    jobs, tobs = observations(8, 16, 5, 1)
    action = np.random.default_rng(9).uniform(-2, 2, size=(16, 2)).astype(np.float32)
    want = jax.jit(jnet.apply)(params, jobs, jnp.asarray(action))
    with torch.no_grad():
        got = tnet(tobs, torch.from_numpy(action))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=RTOL, atol=1e-5)
    assert n(got[1]).shape == (16, 51)
    atoms = n(got[2])
    for reference in (jnp.linspace(-100.0, 100.0, 51),
                      jax.jit(lambda: jnp.linspace(-100.0, 100.0, 51))(), want[2]):
        assert np.abs(atoms - np.asarray(reference)).max() <= np.spacing(np.float32(100.0))
    np.testing.assert_array_equal(atoms, np.arange(-100, 101, 4, dtype=np.float32))
