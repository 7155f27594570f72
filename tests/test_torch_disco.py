"""The Disco pieces of the PyTorch port against the JAX package's, on the
CPU: `networks/heads.py::LinearHead`, `networks/disco.py` (the
action-conditioned LSTM torso, with and without a root MLP, and the agent
network) with carried flax params, batched and on one unbatched observation
(1e-5 relative, 1e-6 floor); `utils/training.py::ElementClipAdam` against
`jax.jit` of `optax.chain(optax.clip, optax.adam)` over 10 steps with
gradients past the clip; the update rule (`systems/disco/update_rule.py`):
its grounded and meta targets (random meta-params carried through the npz
layout), per-step loss and new meta-state against the JAX rule's under
`jax.jit` on the same inputs, with terminal steps and spread advantages; and
the meta-params' npz: a JAX-written file loads exactly, a port-written one
loads in the JAX package, an incompatible file and no path fall back to
random meta-params (`pretrained` False) without any download."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.networks import disco as jax_disco
from stoix_tpu.networks import heads as jax_heads
from stoix_tpu.networks import torso as jax_torso
from stoix_tpu.systems.disco import update_rule as jax_rule
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.networks.disco import (
    ActionConditionedLSTMTorso, DiscoAgentNetwork, DiscoAgentOutput,
)
from stoix_tpu_torch.networks.heads import LinearHead
from stoix_tpu_torch.networks.torso import MLPTorso
from stoix_tpu_torch.systems.disco import update_rule
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.training import ElementClipAdam
from torch_parity import n, t

A, B, OBS = 3, 21, 5


def close(got, want, rtol=1e-5, floor=1e-6):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=rtol, atol=floor)


@pytest.mark.parametrize("output_dim", [1, 7])
def test_linear_head_matches_flax(output_dim):
    x = np.random.default_rng(0).normal(size=(4, 6, 9)).astype(np.float32)
    head = jax_heads.LinearHead(output_dim=output_dim)
    params = head.init(jax.random.PRNGKey(1), jnp.asarray(x))
    port = load_flax_params(LinearHead(output_dim, 9), params)
    close(port(t(x)), head.apply(params, jnp.asarray(x)))
    assert port(t(x)).shape == ((4, 6) if output_dim == 1 else (4, 6, 7))


@pytest.mark.parametrize("root_mlp_sizes", [(), (8, 6)])
def test_action_conditioned_torso_matches_flax(root_mlp_sizes):
    x = np.random.default_rng(2).normal(size=(2, 3, 10)).astype(np.float32)
    torso = jax_disco.ActionConditionedLSTMTorso(num_actions=A, lstm_size=16,
                                                 root_mlp_sizes=root_mlp_sizes)
    params = torso.init(jax.random.PRNGKey(3), jnp.asarray(x))
    port = load_flax_params(ActionConditionedLSTMTorso(A, 10, 16, root_mlp_sizes), params)
    close(port(t(x)), torso.apply(params, jnp.asarray(x)))
    close(port(t(x[0, 0])), torso.apply(params, jnp.asarray(x[0, 0])))
    assert port(t(x)).shape == (2, 3, A, 16)


def agent_pair(seed=0):
    """The JAX and the port's Disco agents carrying the same params."""
    net = jax_disco.DiscoAgentNetwork(
        shared_torso=jax_torso.MLPTorso(layer_sizes=[32, 32], activation="relu"),
        action_conditional_torso=jax_disco.ActionConditionedLSTMTorso(num_actions=A,
                                                                      lstm_size=16),
        logits_head=jax_heads.LinearHead(output_dim=A),
        q_head=jax_heads.LinearHead(output_dim=B), y_head=jax_heads.LinearHead(output_dim=B),
        z_head=jax_heads.LinearHead(output_dim=B), aux_pi_head=jax_heads.LinearHead(output_dim=A))
    obs = observation(seed, (1,))[0]
    params = net.init(jax.random.PRNGKey(seed), obs)
    port = DiscoAgentNetwork(
        MLPTorso(OBS, (32, 32), activation="relu"), ActionConditionedLSTMTorso(A, 32, 16),
        LinearHead(A, 32), LinearHead(B, 16), LinearHead(B, 32), LinearHead(B, 16),
        LinearHead(A, 16))
    return net, params, load_flax_params(port, params)


def observation(seed, lead):
    rng = np.random.default_rng(seed)
    view = rng.normal(size=lead + (OBS,)).astype(np.float32)
    mask = np.ones(lead + (A,), np.float32)
    steps = np.zeros(lead, np.int32)
    return (JaxObservation(jnp.asarray(view), jnp.asarray(mask), jnp.asarray(steps)),
            Observation(t(view), t(mask), t(steps)))


def test_agent_network_matches_flax_batched_and_on_one_observation():
    net, params, port = agent_pair()
    for lead in ((6,), (2, 4), ()):
        jobs, obs = observation(4, lead)
        want, got = net.apply(params, jobs), port(obs)
        for name in DiscoAgentOutput._fields:
            close(getattr(got, name), getattr(want, name))
        assert got.q.shape == lead + (A, B) and got.aux_pi.shape == lead + (A, A)


def test_load_flax_params_refuses_missing_extra_and_misshapen_disco_keys():
    _, params, port = agent_pair()
    inner = jax.tree.map(np.asarray, params["params"])
    missing = {k: v for k, v in inner.items() if k != "y_head"}
    with pytest.raises(ValueError, match="missing flax parameter for y_head"):
        load_flax_params(port, {"params": missing})
    with pytest.raises(ValueError, match="extra flax parameter"):
        load_flax_params(port, {"params": {**inner, "w_head": inner["y_head"]}})
    torso = dict(inner["action_conditional_torso"])
    torso["root_cell"] = {"kernel": np.zeros((32, 15), np.float32),
                          "bias": np.zeros((15,), np.float32)}
    with pytest.raises(ValueError, match="action_conditional_torso.root_cell.weight"):
        load_flax_params(port, {"params": {**inner, "action_conditional_torso": torso}})


def test_element_clip_adam_matches_optax_chain_of_clip_and_adam():
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: (3.0 * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
             for _ in range(10)]
    assert max(np.abs(g["w"]).max() for g in grads) > 1.0
    optim = optax.chain(optax.clip(1.0), optax.adam(1e-3, eps=1e-5))
    update = jax.jit(optim.update)
    jparams, jstate = jax.tree.map(jnp.asarray, params), optim.init(params)
    port = ElementClipAdam(1e-3, 1.0, eps=1e-5)
    tparams = {k: t(v) for k, v in params.items()}
    tstate = port.init(tparams)
    for g in grads:
        jupdates, jstate = update(jax.tree.map(jnp.asarray, g), jstate)
        jparams = optax.apply_updates(jparams, jupdates)
        tupdates, tstate = port.update({k: t(v) for k, v in g.items()}, tstate)
        tparams = {k: tparams[k] + tupdates[k] for k in tparams}
        for k in params:
            np.testing.assert_allclose(n(tupdates[k]), np.asarray(jupdates[k]), rtol=0,
                                       atol=1e-6 * float(np.abs(jupdates[k]).max()))
            np.testing.assert_allclose(n(tparams[k]), np.asarray(jparams[k]), rtol=0, atol=1e-6)
    assert tstate.count == 10


# ---------------------------------------------------------------- the rule

T, E = 6, 5


def rule_inputs(seed, spread=1.0):
    """(JAX inputs, port inputs, JAX target outputs, port target outputs): a
    [T, E] minibatch with terminal steps, head logits of the given spread."""
    rng = np.random.default_rng(seed)

    def head_out(scale):
        shapes = {"logits": (A,), "q": (A, B), "y": (B,), "z": (A, B), "aux_pi": (A, A)}
        return {k: rng.normal(0.0, scale, (T, E) + shape) for k, shape in shapes.items()}

    current, behaviour, target = (
        {k: v.astype(np.float32) for k, v in head_out(s).items()} for s in (1.0, 1.0, spread))
    actions = rng.integers(0, A, (T, E)).astype(np.int32)
    rewards = rng.normal(0.0, 2.0, (T - 1, E)).astype(np.float32)
    terminal = rng.random((T - 1, E)) < 0.25
    terminal[0, 0] = True
    jobs, obs = observation(seed + 1, (T, E))

    def jax_side(d):
        return jax_disco.DiscoAgentOutput(**{k: jnp.asarray(v) for k, v in d.items()})

    def port_side(d):
        return DiscoAgentOutput(**{k: t(v) for k, v in d.items()})

    jin = jax_rule.UpdateRuleInputs(jobs, jnp.asarray(actions), jnp.asarray(rewards),
                                    jnp.asarray(terminal), jax_side(current), jax_side(behaviour))
    tin = update_rule.UpdateRuleInputs(obs, t(actions), t(rewards), t(terminal),
                                       port_side(current), port_side(behaviour))
    return jin, tin, jax_side(target), port_side(target)


def rules(mode, vmax=10.0):
    kwargs = dict(num_actions=A, num_bins=B, vmax=vmax, mode=mode, target_ema=0.9,
                  policy_temperature=0.25)
    return jax_rule.DiscoUpdateRule(**kwargs), update_rule.DiscoUpdateRule(**kwargs)


def close_targets(got, want):
    """Targets: the policy, z and aux_pi logits 1e-5 relative (1e-6 floor);
    q and y, logs of two-hot mixtures, in probability space 1e-5 absolute:
    G and E[q] reach vmax = 10, where a float32 ulp is 9.5e-7, and E[q]
    sums 21 bins in another order; the two-hot moves its mass by G's error
    over a bin width of 1."""
    for key in ("pi", "z", "aux_pi"):
        close(got[key], want[key])
    for key in ("q", "y"):
        np.testing.assert_allclose(np.exp(n(got[key])), np.exp(np.asarray(want[key])), rtol=0,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("spread", [1.0, 8.0])
def test_grounded_targets_match_jax(spread):
    jrule, rule = rules("grounded")
    jin, tin, jtarget, target = rule_inputs(7, spread)
    want = jax.jit(jrule._grounded_targets, static_argnums=2)(jin, jtarget, 0.9)
    got = rule.grounded_targets(tin, target, 0.9)
    close_targets(got, want)
    # The support (C17): within a float32 ulp of vmax of XLA's linspace.
    np.testing.assert_allclose(n(rule.support), np.asarray(jrule.support), rtol=0,
                               atol=float(np.spacing(np.float32(10.0))))
    # The executed action's q target is a two-hot of G; a terminal cuts the bootstrap.
    probs = np.exp(n(got["q"]))
    g0 = probs[0, 0, int(tin.actions[0, 0])] @ n(rule.support)
    np.testing.assert_allclose(g0, n(tin.rewards[0, 0]), rtol=0, atol=1e-4)


def test_meta_targets_match_jax_with_random_meta_params(tmp_path):
    jrule, rule = rules("meta")
    jmeta = jrule.init_params(jax.random.PRNGKey(9))
    path = tmp_path / "meta.npz"
    np.savez(path, **jax_rule.flatten_meta_params(jmeta))
    meta, pretrained = update_rule.load_meta_params(rule, torch.Generator(), str(path))
    assert pretrained
    jin, tin, jtarget, target = rule_inputs(11)
    want = jax.jit(jrule._meta_targets, static_argnums=3)(jmeta, jin, jtarget, 0.97)
    got = rule.meta_targets(meta, tin, target, 0.97)
    for key in want:
        close(got[key], want[key])


@pytest.mark.parametrize("mode", ["grounded", "meta"])
def test_rule_loss_and_meta_state_match_jax(mode, tmp_path):
    jrule, rule = rules(mode)
    jmeta = jrule.init_params(jax.random.PRNGKey(13))
    path = tmp_path / "meta.npz"
    np.savez(path, **jax_rule.flatten_meta_params(jmeta))
    meta, _ = update_rule.load_meta_params(rule, torch.Generator(), str(path))
    jin, tin, jtarget, target = rule_inputs(17, 4.0)
    rng = np.random.default_rng(19)
    agent = {"w": rng.normal(size=(4, 3)).astype(np.float32),
             "b": rng.normal(size=(3,)).astype(np.float32)}
    ema = {k: v + rng.normal(0.0, 0.1, v.shape).astype(np.float32) for k, v in agent.items()}

    def jax_call(meta_params, agent_params, inputs, meta_state):
        unroll = lambda p, s, o, m: (jtarget._asdict(), s)  # noqa: E731
        return jrule(meta_params, agent_params, None, inputs, {"gamma": 0.95}, meta_state, unroll,
                     jax.random.PRNGKey(0))

    jstate = jax_rule.MetaState(jax.tree.map(jnp.asarray, ema), jnp.asarray(3, jnp.int32))
    want_loss, want_state, want_logs = jax.jit(jax_call)(jmeta, jax.tree.map(jnp.asarray, agent),
                                                          jin, jstate)
    state = update_rule.MetaState({k: t(v) for k, v in ema.items()},
                                  torch.tensor(3, dtype=torch.int32))
    loss, new_state, logs = rule(meta, {k: t(v) for k, v in agent.items()}, tin,
                                 {"gamma": 0.95}, state, lambda p, o: target)
    close(loss, want_loss)
    assert loss.shape == (T, E)
    for key in want_logs:
        close(logs[key], want_logs[key])
    for key in agent:
        close(new_state.target_params[key], want_state.target_params[key], rtol=0)
    assert int(new_state.num_updates) == int(want_state.num_updates) == 4


def test_rule_gradient_flows_only_through_the_predictions():
    _, rule = rules("grounded")
    _, tin, _, target = rule_inputs(23)
    logits = tin.agent_out.logits.clone().requires_grad_(True)
    inputs = tin._replace(agent_out=tin.agent_out._replace(logits=logits))
    params = {"w": torch.zeros(2, requires_grad=True)}
    state = update_rule.DiscoUpdateRule.init_meta_state({"w": torch.ones(2)})
    loss, new_state, _ = rule(None, params, inputs, {"gamma": 0.9}, state,
                              lambda p, o: target)
    loss.mean().backward()
    assert logits.grad is not None and float(logits.grad.abs().sum()) > 0.0
    assert params["w"].grad is None and not new_state.target_params["w"].requires_grad


# ---------------------------------------------------------------- the npz


def test_load_meta_params_reads_a_jax_written_npz_exactly(tmp_path):
    jrule, rule = rules("meta")
    saved = jrule.init_params(jax.random.PRNGKey(7))
    path = tmp_path / "disco_103.npz"
    np.savez(path, **jax_rule.flatten_meta_params(saved))
    loaded, pretrained = update_rule.load_meta_params(rule, torch.Generator(), str(path))
    assert pretrained
    flat = jax_rule.flatten_meta_params(saved)
    assert update_rule.flatten_meta_params(loaded).keys() == flat.keys()
    for key, value in update_rule.flatten_meta_params(loaded).items():
        np.testing.assert_array_equal(value, flat[key])
    params = load_flax_params(rule.meta_net, jax.tree.map(np.asarray, saved))
    for name, value in params.named_parameters():
        assert torch.equal(value, loaded[name]), name


def test_a_port_written_npz_loads_in_the_jax_package(tmp_path):
    jrule, rule = rules("meta")
    params = rule.init_params(torch.Generator().manual_seed(3))
    path = tmp_path / "disco_103.npz"
    np.savez(path, **update_rule.flatten_meta_params(params))
    loaded, pretrained = jax_rule.load_meta_params(jrule, jax.random.PRNGKey(0),
                                                   local_path=str(path))
    assert pretrained
    for key, value in jax_rule.flatten_meta_params(loaded).items():
        np.testing.assert_array_equal(value, update_rule.flatten_meta_params(params)[key])


def test_an_incompatible_npz_and_no_path_fall_back_to_random_meta_params(tmp_path):
    _, rule = rules("meta")
    path = tmp_path / "disco_103.npz"
    np.savez(path, **{"lstm/w": np.zeros((4, 4)), "lstm/b": np.zeros((4,))})
    template = rule.init_params(torch.Generator().manual_seed(1))
    for local_path in (str(path), None, str(tmp_path / "absent.npz")):
        loaded, pretrained = update_rule.load_meta_params(
            rule, torch.Generator().manual_seed(1), local_path)
        assert not pretrained
        assert loaded.keys() == template.keys()
        for key, value in loaded.items():
            assert torch.equal(value, template[key]), key
    # A file of the right keys but a wrong shape falls back too.
    flat = update_rule.flatten_meta_params(template)
    flat["params/Dense_0/kernel"] = np.zeros((3, 3), np.float32)
    np.savez(path, **flat)
    assert not update_rule.load_meta_params(rule, torch.Generator(), str(path))[1]
