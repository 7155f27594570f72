"""Anakin rec_r2d2 of the PyTorch port (systems/q_learning/rec_r2d2.py)
against the JAX package's, on the CPU.

1. The recurrent Q-network with the flax params of the JAX package's
   RecurrentActor carried across: Q values and carries over a sequence with
   resets, 1e-5 relative (1e-6 floor).
2. One update epoch (twice) from identical online and target params on
   explicit PrioritisedSamples of [B, burn-in + train] sequences with stored
   carries and reset flags, against the JAX package's composition of
   stoix_tpu/systems/q_learning/rec_r2d2.py:71-139 (burn-in without
   gradient, the online argmax selecting, `signed_parabolic` of the target's
   Q, `n_step_bootstrapped_returns`, `signed_hyperbolic`, eta . max +
   (1 - eta) . mean of |td| as the priorities, mean(w . td^2 / 2), clip +
   Adam eps 1e-5, `optax.incremental_update`) under
   `jax.vmap(axis_name="batch")` with the gradients' pmean: the GRU at
   `update_batch_size` 1 and 2, and the LSTM; the loss and the priorities
   1e-5 relative, online and target params 1e-5 absolute.
3. The rollout stores each step's carry at its START and the reset flag
   entering it: re-unrolling the network from the first stored carry with
   the stored flags gives every later stored carry (1e-6).
4. A resume after window 1 is bitwise the unbroken run, the buffer, its
   priorities and the carries included; the three cells A9b ports run;
   `system.update_guard`, which the JAX rec_r2d2 does not read, is refused.
5. The IdentityGame oracle (> 8.0; buffer 4096, batch 16, 16 envs, 131 072
   steps), where the JAX package's rec_r2d2 returns 8.99 (seeds 42 and 1,
   scripts/jax_oracle_thresholds.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu.base_types import OnlineAndTarget as JaxOnlineAndTarget
from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.networks import base as jbase
from stoix_tpu.networks import heads as jheads
from stoix_tpu.networks import inputs as jinputs
from stoix_tpu.networks import torso as jtorso
from stoix_tpu.ops import SIGNED_HYPERBOLIC_PAIR, n_step_bootstrapped_returns
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch.base_types import OnlineAndTarget
from stoix_tpu_torch.buffers import PrioritisedSample
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.q_learning import q_family, rec_r2d2
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.training import ClipAdam
from stoix_tpu_torch.utils.tree import tree_map
from torch_dp_worker import r2d2_network
from torch_parity import n, t, to_flax_params

OBS_DIM, ACTIONS, HIDDEN, BATCH = 5, 3, 6, 12
BURN, TRAIN, N_STEP = 4, 5, 3
ROOT = "default/anakin/default_rec_r2d2.yaml"
SEQ = [f"system.burn_in_length={BURN}", f"system.train_length={TRAIN}",
       f"system.n_step={N_STEP}", "system.q_lr=1e-3"]


def _configs(overrides=()):
    overrides = ["env=identity_game", *SEQ, *overrides]
    return (config_lib.compose(config_lib.default_config_dir(), ROOT, overrides),
            jax_config.compose(jax_config.default_config_dir(), ROOT, overrides))


def _flax_network(cell_type):
    return jbase.RecurrentActor(
        action_head=jheads.DiscreteQNetworkHead(action_dim=ACTIONS, epsilon=0.0),
        rnn=jbase.ScannedRNN(hidden_size=HIDDEN, cell_type=cell_type),
        pre_torso=jtorso.MLPTorso((8,)), post_torso=jtorso.MLPTorso((8,)),
        input_layer=jinputs.ObservationInput())


def paired_networks(cell_type, seed=0):
    """(flax net, online params, target params, port net, port online, port
    target): the JAX package's RecurrentActor and the port's
    RecurrentQNetwork with the same two parameter sets."""
    jax_net = _flax_network(cell_type)
    dummy = (JaxObservation(jnp.zeros((1, 1, OBS_DIM)), jnp.ones((1, 1, ACTIONS)),
                            jnp.zeros((1, 1), jnp.int32)), jnp.zeros((1, 1), bool))
    h = jbase.ScannedRNN.initialize_carry(cell_type, HIDDEN, (1,))
    online, target = (jax.tree.map(np.asarray, jax_net.init(jax.random.PRNGKey(s), h, dummy))
                      for s in (seed, seed + 1))
    port = r2d2_network(cell_type, HIDDEN)
    load_flax_params(port, target)
    port_target = {k: v.detach().clone() for k, v in port.named_parameters()}
    load_flax_params(port, online)
    port_online = {k: v.detach().clone() for k, v in port.named_parameters()}
    return jax_net, online, target, port, port_online, port_target


def _carry(cell_type, lead, rng):
    draw = lambda: rng.normal(size=lead + (HIDDEN,)).astype(np.float32)  # noqa: E731
    return (draw(), draw()) if cell_type in ("lstm", "optimised_lstm") else draw()


def _observations(rng, lead):
    return (rng.normal(size=lead + (OBS_DIM,)).astype(np.float32),
            np.ones(lead + (ACTIONS,), np.float32), np.zeros(lead, np.int32))


@pytest.mark.parametrize("cell_type", ["gru", "lstm"])
def test_recurrent_q_network_with_carried_params_matches_flax(cell_type):
    jax_net, online, _, port, _, _ = paired_networks(cell_type)
    rng = np.random.default_rng(1)
    obs = _observations(rng, (7, 4))
    done = rng.random((7, 4)) < 0.25
    h0 = _carry(cell_type, (4,), rng)
    want_h, want = jax_net.apply(online, jax.tree.map(jnp.asarray, h0),
                                 (JaxObservation(*map(jnp.asarray, obs)), jnp.asarray(done)))
    got_h, got = port(jax.tree.map(t, h0), (Observation(*map(t, obs)), t(done)))
    np.testing.assert_allclose(n(got), np.asarray(want.preferences), rtol=1e-5, atol=1e-6)
    for g, w in zip(jax.tree.leaves(got_h), jax.tree.leaves(want_h)):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-5, atol=1e-6)
    back = to_flax_params(dict(port.named_parameters()), online)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, w), back, online)


def _sample(seed, cell_type):
    """A PrioritisedSample's [B, L] sequences (numpy) and probabilities."""
    rng = np.random.default_rng(seed)
    lead = (BATCH, BURN + TRAIN)
    return {
        "obs": _observations(rng, lead),
        "action": rng.integers(0, ACTIONS, lead).astype(np.int32),
        "reward": (rng.normal(size=lead) * 2 + 1).astype(np.float32),
        "discount": (rng.random(lead) > 0.15).astype(np.float32),
        "done": rng.random(lead) < 0.15,
        "hstate": _carry(cell_type, lead, rng),
    }, (rng.random(BATCH) * 0.02 + 1e-4).astype(np.float32)


def _jax_experience(raw):
    return {k: (JaxObservation(*map(jnp.asarray, v)) if k == "obs" else
                jax.tree.map(jnp.asarray, v)) for k, v in raw.items()}


def _port_sample(raw, probs):
    experience = {k: (Observation(*map(t, v)) if k == "obs" else jax.tree.map(t, v))
                  for k, v in raw.items()}
    return PrioritisedSample(experience, torch.zeros((BATCH, 2), dtype=torch.long), t(probs))


def _jax_update(jax_net, jcfg, optim, axes=()):
    """rec_r2d2.py's _loss_fn and _update_epoch (:71-139), the gradients
    pmeaned over each of `axes` in turn (`pmean_grads`: "batch", "data")."""
    s = jcfg.system
    gamma, tau, n_step = float(s.gamma), float(s.tau), int(s.n_step)
    burn_in, eta = int(s.burn_in_length), float(s.priority_eta)
    beta = float(s.importance_sampling_exponent)
    tx = SIGNED_HYPERBOLIC_PAIR

    def apply(params, h, inputs):
        h, dist = jax_net.apply(params, h, inputs)
        return h, dist.preferences

    def loss_fn(online_params, target_params, seq, probs):
        tm = lambda x: jnp.swapaxes(x, 0, 1)  # noqa: E731
        obs = jax.tree.map(tm, seq["obs"])
        dones = tm(seq["done"])
        init_h = jax.tree.map(lambda x: x[:, 0], seq["hstate"])
        burn_obs = jax.tree.map(lambda x: x[:burn_in], obs)
        rest_obs = jax.tree.map(lambda x: x[burn_in:], obs)
        burn_dones, rest_dones = dones[:burn_in], dones[burn_in:]
        h_online, _ = apply(online_params, init_h, (burn_obs, burn_dones))
        h_target, _ = apply(target_params, init_h, (burn_obs, burn_dones))
        h_online = jax.lax.stop_gradient(h_online)
        h_target = jax.lax.stop_gradient(h_target)
        _, q_online = apply(online_params, h_online, (rest_obs, rest_dones))
        _, q_target = apply(target_params, h_target, (rest_obs, rest_dones))
        action = tm(seq["action"])[burn_in:]
        reward = tm(seq["reward"])[burn_in:]
        discount = tm(seq["discount"])[burn_in:]
        selector = jnp.argmax(q_online, axis=-1)
        v_raw = tx.apply_inv(jnp.take_along_axis(q_target, selector[..., None], axis=-1)[..., 0])
        targets = n_step_bootstrapped_returns(
            reward[:-1].swapaxes(0, 1), (gamma * discount[:-1]).swapaxes(0, 1),
            v_raw[1:].swapaxes(0, 1), n=n_step).swapaxes(0, 1)
        targets = tx.apply(targets)
        qa = jnp.take_along_axis(q_online, action[..., None], axis=-1)[..., 0][:-1]
        td = jax.lax.stop_gradient(targets) - qa
        abs_td = jnp.abs(td)
        new_priorities = eta * jnp.max(abs_td, axis=0) + (1.0 - eta) * jnp.mean(abs_td, axis=0)
        weights = (1.0 / jnp.maximum(probs, 1e-9)) ** beta
        weights = weights / jnp.max(weights)
        loss = jnp.mean(weights[None, :] * 0.5 * td ** 2)
        return loss, (new_priorities, loss)

    def update(params, opt_state, seq, probs, draws=()):
        del draws  # R2D2 draws nothing in its loss
        grads, (priorities, loss) = jax.grad(loss_fn, has_aux=True)(
            params.online, params.target, seq, probs)
        for axis in axes:
            grads = jax.lax.pmean(grads, axis_name=axis)
        updates, opt_state = optim.update(grads, opt_state)
        online = optax.apply_updates(params.online, updates)
        return (JaxOnlineAndTarget(online, optax.incremental_update(online, params.target, tau)),
                opt_state), (loss, priorities)

    return update


def _assert_params(port, want, like):
    got = to_flax_params(port, like)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("cell_type,update_batch", [("gru", 1), ("gru", 2), ("lstm", 1)])
def test_update_epochs_match_jax(cell_type, update_batch):
    cfg, jcfg = _configs([f"arch.update_batch_size={update_batch}",
                          f"network.rnn_cell_type={cell_type}", f"network.rnn_hidden_size={HIDDEN}"])
    jax_net, online, target, port, port_online, port_target = paired_networks(cell_type)
    optim = optax.chain(optax.clip_by_global_norm(float(jcfg.system.max_grad_norm)),
                        optax.adam(float(jcfg.system.q_lr), eps=1e-5))
    stack = lambda *xs: jax.tree.map(lambda *a: jnp.stack(a), *xs)  # noqa: E731
    axis = "batch" if update_batch > 1 else None
    update = _jax_update(jax_net, jcfg, optim, (axis,) if axis else ())
    update = jax.jit(jax.vmap(update, axis_name=axis) if axis else update)
    params, state = JaxOnlineAndTarget(online, target), optim.init(online)
    if axis:
        params, state = stack(*[params] * 2), stack(*[state] * 2)
    port_optim = ClipAdam(float(cfg.system.q_lr), float(cfg.system.max_grad_norm), eps=1e-5)
    port_update = q_family.PrioritisedQUpdate(rec_r2d2.r2d2_loss, rec_r2d2.make_apply_fn(port),
                                              port_optim, cfg)
    tparams = [OnlineAndTarget(port_online, port_target)] * update_batch
    topt = [port_optim.init(port_online)] * update_batch
    for epoch in range(2):
        samples = [_sample(10 * epoch + u, cell_type) for u in range(update_batch)]
        if axis:
            seq = stack(*(_jax_experience(s[0]) for s in samples))
            probs = jnp.stack([jnp.asarray(s[1]) for s in samples])
        else:
            seq, probs = _jax_experience(samples[0][0]), jnp.asarray(samples[0][1])
        (params, state), (loss, priorities) = update(params, state, seq, probs)
        tparams, topt, info, got = port_update(
            tparams, topt, [_port_sample(*s) for s in samples], [None] * update_batch)
        np.testing.assert_allclose(n(info["q_loss"]), np.asarray(loss), rtol=1e-5)
        np.testing.assert_allclose(np.stack([n(p) for p in got]).reshape(np.shape(priorities)),
                                   np.asarray(priorities), rtol=1e-5, atol=1e-6)
    for u in range(update_batch):
        pick = (lambda x: x[u]) if axis else (lambda x: x)
        _assert_params(tparams[u].online, jax.tree.map(pick, params.online), online)
        _assert_params(tparams[u].target, jax.tree.map(pick, params.target), online)


TINY = ["env=identity_game", "arch.total_num_envs=8", "arch.num_updates_per_eval=2",
        "arch.num_eval_episodes=4", "arch.absolute_metric=False", "system.rollout_length=8",
        "system.epochs=2", "system.total_buffer_size=256", "system.total_batch_size=8",
        "system.burn_in_length=4", "system.train_length=4", "system.period=2",
        "logger.use_console=False"]


@pytest.mark.parametrize("cell_type", ["gru", "lstm"])
def test_rollout_stores_the_carries_each_step_starts_from(cell_type):
    config = config_lib.compose(config_lib.default_config_dir(), ROOT, TINY + [
        f"network.rnn_cell_type={cell_type}", "arch.num_updates=2", "arch.num_evaluation=1"])
    env, _ = rec_r2d2.envs.make(config)
    setup = rec_r2d2.learner_setup(env, config, torch.device("cpu"), seed=3)
    learner = setup.learn
    state, _ = learner.rollout(setup.learner_state)  # the second rollout starts mid-episode
    state, traj = learner.rollout(state)
    apply = learner.q_apply
    h = tree_map(lambda x: x[0], traj["hstate"])
    for step in range(traj["done"].shape[0]):
        inputs = (tree_map(lambda x: x[step:step + 1], traj["obs"]), traj["done"][step:step + 1])
        h, _ = apply(state.params.online, h, inputs)
        want = state.hstates if step + 1 == traj["done"].shape[0] else tree_map(
            lambda x: x[step + 1], traj["hstate"])
        for g, w in zip(jax.tree.leaves(h), jax.tree.leaves(want)):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    # Each step stores the reset flag entering it: the previous step's end.
    ended = traj["discount"][:-1] == 0.0
    assert torch.equal(traj["done"][1:] & ended, ended)
    assert traj["hstate"] is not None and state.buffer_state.num_added == 16


def test_resume_after_window_one_is_bitwise_the_unbroken_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    window = 2 * 8 * 8

    def run(uid, windows, extra=()):
        config = config_lib.compose(config_lib.default_config_dir(), ROOT, TINY + [
            "network.rnn_cell_type=lstm", "logger.checkpointing.save_model=true",
            f"logger.checkpointing.save_args.checkpoint_uid={uid}",
            "logger.checkpointing.save_args.max_to_keep=~", f"arch.num_evaluation={windows}",
            f"arch.total_timesteps={windows * window}", *extra])
        rec_r2d2.run_experiment(config, device="cpu")

    run("unbroken", 2)
    run("first", 1)
    run("resumed", 1, ["logger.checkpointing.load_model=true",
                       "logger.checkpointing.load_args.checkpoint_uid=first"])
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == window
    load = lambda uid: torch.load(  # noqa: E731
        os.path.join(tmp_path, "checkpoints", uid, "rec_r2d2", str(2 * window), "state.pt"),
        weights_only=True)
    unbroken, resumed = load("unbroken"), load("resumed")
    assert unbroken.keys() == resumed.keys()
    for key, value in unbroken.items():
        other = resumed[key]
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, other), key
        elif isinstance(value, dict):
            assert torch.equal(value["generator_state"], other["generator_state"]), key
        else:
            assert value == other, key
    assert {"hstates/0", "hstates/1", "buffer_state/priorities",
            "buffer_state/experience/hstate/0"} <= set(unbroken)


@pytest.mark.parametrize("cell_type", ["optimised_lstm", "mgu", "simple"])
def test_rec_r2d2_runs_every_rnn_cell(cell_type):
    config = config_lib.compose(config_lib.default_config_dir(), ROOT, TINY + [
        f"network.rnn_cell_type={cell_type}", "arch.num_updates=2", "arch.num_evaluation=1"])
    assert np.isfinite(rec_r2d2.run_experiment(config, device="cpu"))
    train = [r for r in runner.LAST_RUN_STATS["history"] if r["event"] == "trainer"]
    assert train and all(np.isfinite(v) for r in train for k, v in r.items()
                         if k not in ("event", "t", "t_eval"))


def test_update_guard_the_reference_ignores_is_refused_naming_the_key():
    config = config_lib.compose(config_lib.default_config_dir(), ROOT,
                                TINY + ["system.update_guard=halt", "arch.num_evaluation=1"])
    with pytest.raises(NotImplementedError, match=r"system\.update_guard"):
        rec_r2d2.run_experiment(config, device="cpu")


# The JAX rec_r2d2 returns 8.99 under these overrides on the CPU (seeds 42 and 1).
IDENTITY = ["env=identity_game", "arch.total_num_envs=16", "arch.num_evaluation=1",
            "arch.num_eval_episodes=32", "arch.total_timesteps=131072",
            "system.total_buffer_size=4096", "system.total_batch_size=16",
            "logger.use_console=False"]


def test_r2d2_learns_identity_game():
    config = config_lib.compose(config_lib.default_config_dir(), ROOT, IDENTITY)
    final_return = rec_r2d2.run_experiment(config, device="cpu")
    assert final_return > 8.0, f"rec_r2d2 failed to learn IdentityGame: {final_return}"
    assert runner.LAST_RUN_STATS["device"] == "cpu"
