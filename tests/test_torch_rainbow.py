"""Anakin ff_rainbow of the PyTorch port (systems/q_learning/ff_rainbow.py)
against the JAX package's, on the CPU.

1. One update epoch (twice, the second reading Adam's moments and a moved
   target) from identical online and target params on explicit
   PrioritisedSamples, with the same standard-normal noise fed to both
   packages (the three draws of the loss: online at s_0, online at s_n,
   target at s_n), against the JAX package's composition of
   stoix_tpu/systems/q_learning/ff_rainbow.py:49-109 (the loss, its
   cumprod n-step return and C51 projection, importance weights normalised
   by the batch maximum, clip + Adam eps 1e-5, `optax.incremental_update`)
   under `jax.vmap(axis_name="batch")` with the gradients' pmean, at
   `update_batch_size` 1 and 2: the loss and the new priorities (the
   cross-entropies) 1e-5 relative, online and target params 1e-5 absolute.
2. The warmup's fill on fixed actions against JAX's `traj_warmup` body
   (ff_rainbow.py:203-227: env steps, the stored dict, the [E, T] swap and
   the prioritised buffer's add) on CartPole from the same states: the
   priorities and counts exact, the experience exact but the physics (1e-5,
   as tests/test_torch_envs.py).
3. A resume after window 1 is bitwise the unbroken run, the buffer and its
   priorities included; `system.update_guard`, which the JAX ff_rainbow does
   not read, is refused naming the key.
4. The IdentityGame oracle (> 8.0) at the overrides where the JAX package
   returns 10.0 (vmin 0, vmax 10, buffer 4096, batch 64, 16 envs, T = 8,
   65 536 steps; seeds 42 and 1).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu.base_types import OnlineAndTarget as JaxOnlineAndTarget
from stoix_tpu.buffers import make_prioritised_trajectory_buffer as jax_make_buffer
from stoix_tpu.envs import classic as jclassic
from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.networks import base as jbase
from stoix_tpu.networks import dueling as jdueling
from stoix_tpu.networks import inputs as jinputs
from stoix_tpu.networks import torso as jtorso
from stoix_tpu.ops import categorical_l2_project as jax_project
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch.base_types import OffPolicyLearnerState, OnlineAndTarget
from stoix_tpu_torch.buffers import PrioritisedSample
from stoix_tpu_torch.envs import classic, wrappers
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.systems import off_policy_core as core, runner
from stoix_tpu_torch.systems.q_learning import ff_rainbow, q_family
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.training import ClipAdam
from stoix_tpu_torch.utils.tree import tree_leaves
from test_torch_envs import _cartpole_state_to_port, _jax_env
from test_torch_q_family import _port_timestep
from torch_dp_worker import rainbow_network
from torch_parity import fed_normals, n, noise_draws, t, to_flax_params

OBS_DIM, ACTIONS, BATCH, N_STEP = 5, 3, 24, 3
ROOT = "default/anakin/default_ff_rainbow.yaml"
HEAD = dict(num_atoms=11, vmin=0.0, vmax=10.0, layer_sizes=(8,))


def _configs(overrides=()):
    overrides = ["env=identity_game", "system.q_lr=1e-3", *overrides]
    return (config_lib.compose(config_lib.default_config_dir(), ROOT, overrides),
            jax_config.compose(jax_config.default_config_dir(), ROOT, overrides))


def _flax_init(net, x, seed):
    """flax params of `net` (its init draws noise too: fed zeros)."""
    shapes = []
    original = jax.random.normal

    def record(key, shape=(), dtype=None):
        shapes.append(tuple(shape))
        return jnp.zeros(shape, jnp.float32)

    jax.random.normal = record
    try:
        jax.eval_shape(lambda: net.init({"params": jax.random.PRNGKey(seed),
                                         "noise": jax.random.PRNGKey(0)}, x))
    finally:
        jax.random.normal = original
    with fed_normals([np.zeros(s, np.float32) for s in shapes]):
        return jax.tree.map(np.asarray, net.init({"params": jax.random.PRNGKey(seed),
                                                  "noise": jax.random.PRNGKey(0)}, x))


def paired_rainbow_networks(seed=0):
    """The flax Rainbow network with online and target params, and the port
    network with the same two as {name: tensor} dicts."""
    jax_net = jbase.FeedForwardActor(
        action_head=jdueling.NoisyDistributionalDuelingQNetwork(action_dim=ACTIONS, **HEAD),
        torso=jtorso.MLPTorso((16,), activation="relu"), input_layer=jinputs.ObservationInput())
    dummy = JaxObservation(jnp.zeros((1, OBS_DIM)), jnp.ones((1, ACTIONS)),
                           jnp.zeros((1,), jnp.int32))
    online, target = _flax_init(jax_net, dummy, seed), _flax_init(jax_net, dummy, seed + 1)
    torch_net = rainbow_network()
    load_flax_params(torch_net, target)
    port_target = {k: v.detach().clone() for k, v in torch_net.named_parameters()}
    load_flax_params(torch_net, online)
    port_online = {k: v.detach().clone() for k, v in torch_net.named_parameters()}
    return jax_net, online, target, torch_net, port_online, port_target


def _sample(seed):
    """A PrioritisedSample's experience [B, n + 1, ...] and probabilities."""
    rng = np.random.default_rng(seed)
    lead = (BATCH, N_STEP + 1)
    obs = (rng.normal(size=lead + (OBS_DIM,)).astype(np.float32),
           np.ones(lead + (ACTIONS,), np.float32), np.zeros(lead, np.int32))
    return {
        "obs": obs, "next_obs": obs,
        "action": rng.integers(0, ACTIONS, lead).astype(np.int32),
        "reward": (rng.normal(size=lead) * 2 + 1).astype(np.float32),
        "discount": (rng.random(lead) > 0.15).astype(np.float32),
    }, (rng.random(BATCH) * 0.02 + 1e-4).astype(np.float32)


def _jax_experience(raw):
    return {k: (JaxObservation(*map(jnp.asarray, v)) if k.endswith("obs") else jnp.asarray(v))
            for k, v in raw.items()}


def _port_sample(raw, probs):
    experience = {k: (Observation(*map(t, v)) if k.endswith("obs") else t(v))
                  for k, v in raw.items()}
    return PrioritisedSample(experience, torch.zeros((BATCH, 2), dtype=torch.long), t(probs))


def _jax_update(jax_net, jcfg, optim, axes=()):
    """ff_rainbow.py's _loss_fn and _update_epoch (:49-109), the gradients
    pmeaned over each of `axes` in turn (`pmean_grads`: "batch", "data")."""
    gamma, tau = float(jcfg.system.gamma), float(jcfg.system.tau)
    beta = float(jcfg.system.importance_sampling_exponent)

    def loss_fn(online_params, target_params, seq, probs):
        key = jax.random.PRNGKey(0)  # the fed normals replace its draws
        k1, k2, k3 = jax.random.split(key, 3)
        obs_0 = jax.tree.map(lambda x: x[:, 0], seq["obs"])
        action_0 = seq["action"][:, 0]
        discounts = gamma * seq["discount"][:, :-1]
        cum = jnp.cumprod(
            jnp.concatenate([jnp.ones_like(discounts[:, :1]), discounts[:, :-1]], axis=1), axis=1)
        r_n = jnp.sum(cum * seq["reward"][:, :-1], axis=1)
        d_n = jnp.prod(discounts, axis=1)
        obs_n = jax.tree.map(lambda x: x[:, -1], seq["obs"])
        _, logits_0, atoms = jax_net.apply(online_params, obs_0, rngs={"noise": k1})
        dist_sel, _, _ = jax_net.apply(online_params, obs_n, rngs={"noise": k2})
        _, logits_n, _ = jax_net.apply(target_params, obs_n, rngs={"noise": k3})
        best_a = jnp.argmax(dist_sel.preferences, axis=-1)
        num_atoms = atoms.shape[0]
        probs_best = jnp.take_along_axis(jax.nn.softmax(logits_n, axis=-1),
                                         best_a[:, None, None].repeat(num_atoms, -1),
                                         axis=-2)[:, 0, :]
        target_z = r_n[:, None] + d_n[:, None] * atoms[None, :]
        target = jax.lax.stop_gradient(jax_project(target_z, probs_best, atoms))
        logits_a = jnp.take_along_axis(logits_0, action_0[:, None, None].repeat(num_atoms, -1),
                                       axis=-2)[:, 0, :]
        ce = -jnp.sum(target * jax.nn.log_softmax(logits_a, axis=-1), axis=-1)
        weights = (1.0 / jnp.maximum(probs, 1e-9)) ** beta
        weights = weights / jnp.max(weights)
        loss = jnp.mean(weights * ce)
        return loss, (ce, loss)

    def update(params, opt_state, seq, probs, draws):
        # The loss's normals come from `draws`, so a jitted update takes new
        # noise at every call.
        with fed_normals(draws) as left:
            grads, (ce, loss) = jax.grad(loss_fn, has_aux=True)(params.online, params.target,
                                                                seq, probs)
            assert not left
        for axis in axes:
            grads = jax.lax.pmean(grads, axis_name=axis)
        updates, opt_state = optim.update(grads, opt_state)
        online = optax.apply_updates(params.online, updates)
        return (JaxOnlineAndTarget(online, optax.incremental_update(online, params.target, tau)),
                opt_state), (loss, ce)

    return update


class FedNoise(ff_rainbow.NoisyQApply):
    """The port's apply with its noise draws replaced by given pairs, in order."""

    def __init__(self, network, pairs):
        super().__init__(network)
        self.pairs = list(pairs)

    def draw_noise(self, generator):
        return self.pairs.pop(0)


def _assert_params(port, want, like):
    got = to_flax_params(port, like)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("update_batch", [1, 2])
def test_update_epochs_match_jax(update_batch):
    cfg, jcfg = _configs([f"arch.update_batch_size={update_batch}"])
    jax_net, online, target, torch_net, port_online, port_target = paired_rainbow_networks()
    optim = optax.chain(optax.clip_by_global_norm(float(jcfg.system.max_grad_norm)),
                        optax.adam(float(jcfg.system.q_lr), eps=1e-5))
    stack = lambda *xs: jax.tree.map(lambda *a: jnp.stack(a), *xs)  # noqa: E731
    axis = "batch" if update_batch > 1 else None
    update = _jax_update(jax_net, jcfg, optim, (axis,) if axis else ())
    if axis:  # one set of draws for both replicas, as one trace under vmap draws
        update = jax.vmap(update, axis_name=axis, in_axes=(0, 0, 0, 0, None))
    update = jax.jit(update)
    params = JaxOnlineAndTarget(online, target)
    state = optim.init(online)
    if axis:
        params, state = stack(*[params] * 2), stack(*[state] * 2)
    port_optim = ClipAdam(float(cfg.system.q_lr), float(cfg.system.max_grad_norm), eps=1e-5)
    tparams = [OnlineAndTarget(port_online, port_target)] * update_batch
    topt = [port_optim.init(port_online)] * update_batch
    for epoch in range(2):
        samples = [_sample(10 * epoch + u) for u in range(update_batch)]
        # Three draws a loss, each a pair a noisy layer; under vmap JAX draws
        # once for both replicas, so both port replicas get the same draws.
        draws, pairs = [], []
        for k in range(3):
            d, p = noise_draws(torch_net, seed=100 * epoch + k)
            draws += d
            pairs.append(p)
        if axis:
            seq = stack(*(_jax_experience(s[0]) for s in samples))
            probs = jnp.stack([jnp.asarray(s[1]) for s in samples])
        else:
            seq, probs = _jax_experience(samples[0][0]), jnp.asarray(samples[0][1])
        (params, state), (loss, ce) = update(params, state, seq, probs, draws)
        fed = FedNoise(torch_net, pairs * update_batch)
        port_update = q_family.PrioritisedQUpdate(ff_rainbow.rainbow_loss, fed, port_optim, cfg)
        tparams, topt, info, priorities = port_update(
            tparams, topt, [_port_sample(*s) for s in samples], [None] * update_batch)
        np.testing.assert_allclose(n(info["q_loss"]), np.asarray(loss), rtol=1e-5)
        np.testing.assert_allclose(np.stack([n(p) for p in priorities]).reshape(np.shape(ce)),
                                   np.asarray(ce), rtol=1e-5, atol=1e-6)
    for u in range(update_batch):
        pick = (lambda x: x[u]) if axis else (lambda x: x)
        _assert_params(tparams[u].online, jax.tree.map(pick, params.online), online)
        _assert_params(tparams[u].target, jax.tree.map(pick, params.target), online)
    assert topt[0].count == 2


def test_warmup_fill_on_fixed_actions_matches_jax(monkeypatch):
    cfg, _ = _configs(["env=cartpole", "arch.total_num_envs=16", "system.warmup_steps=5",
                       "system.rollout_length=4", "system.total_buffer_size=256",
                       "arch.num_updates_per_eval=1"])
    cfg.system.action_dim = 2
    actions = np.random.default_rng(6).integers(0, 2, (5, 16)).astype(np.int32)
    jenv, (jstate, jts) = _jax_env(jclassic.CartPole())
    tenv = wrappers.apply_core_wrappers(classic.CartPole())
    gen = torch.Generator().manual_seed(0)
    start = OffPolicyLearnerState(None, None, None, gen, _cartpole_state_to_port(jstate, gen),
                                  _port_timestep(jts))
    # JAX: traj_warmup's body (ff_rainbow.py:203-227) with the fixed actions.
    local_envs, sample_batch, max_length = core.trajectory_buffer_sizing(cfg, 8)
    assert (local_envs, sample_batch, max_length) == (16, 256, 16)
    jbuf = jax_make_buffer(add_batch_size=16, sample_batch_size=sample_batch,
                           sample_sequence_length=N_STEP + 1, period=1,
                           max_length_time_axis=max_length)
    steps, ts = [], jts
    for a in actions:
        jstate, next_ts = jenv.step(jstate, jnp.asarray(a))
        steps.append({"obs": ts.observation, "action": jnp.asarray(a), "reward": next_ts.reward,
                      "discount": next_ts.discount, "next_obs": next_ts.extras["next_obs"]})
        ts = next_ts
    dummy = {"obs": jenv.observation_value(), "action": jnp.zeros((), jnp.int32),
             "reward": jnp.zeros(()), "discount": jnp.zeros(()),
             "next_obs": jenv.observation_value()}
    traj = jax.tree.map(lambda *x: jnp.stack(x), *steps)
    want = jbuf.add(jbuf.init(dummy), jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), traj))
    # The port: its warmup with the same actions in place of its draws.
    buffer = ff_rainbow.make_prioritised_trajectory_buffer(
        add_batch_size=16, sample_batch_size=sample_batch, sample_sequence_length=N_STEP + 1,
        period=1, max_length_time_axis=max_length)
    learner = core.OffPolicyLearner(tenv, buffer, cfg, update_from_batch=None, act_in_env=None,
                                    store=ff_rainbow.store_step)
    draws = iter(actions)
    monkeypatch.setattr(q_family.torch, "randint",
                        lambda low, high, size, generator, device: t(next(draws)).long())
    got = q_family.get_discrete_warmup_fn(learner, cfg)(
        start._replace(buffer_state=buffer.init(ff_rainbow.dummy_item(tenv, "cpu")))).buffer_state
    monkeypatch.undo()
    assert (got.insert_pos, got.num_added) == (int(want.insert_pos), int(want.num_added)) == (5, 5)
    np.testing.assert_array_equal(n(got.priorities), np.asarray(want.priorities))
    assert got.experience.keys() == want.experience.keys()
    for key in want.experience:
        for g, w in zip(tree_leaves(got.experience[key]), jax.tree.leaves(want.experience[key])):
            np.testing.assert_allclose(n(g).astype(np.float64), np.asarray(w).astype(np.float64),
                                       rtol=0, atol=1e-5, err_msg=key)


TINY = ["env=identity_game", "arch.total_num_envs=8", "arch.num_updates_per_eval=2",
        "arch.num_eval_episodes=4", "arch.absolute_metric=False", "system.rollout_length=4",
        "system.epochs=2", "system.warmup_steps=4", "system.total_buffer_size=256",
        "system.total_batch_size=16", "system.vmin=0.0", "system.vmax=10.0",
        "logger.use_console=False"]


def test_resume_after_window_one_is_bitwise_the_unbroken_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    window = 2 * 4 * 8

    def run(uid, windows, extra=()):
        config = config_lib.compose(config_lib.default_config_dir(), ROOT, TINY + [
            "logger.checkpointing.save_model=true",
            f"logger.checkpointing.save_args.checkpoint_uid={uid}",
            "logger.checkpointing.save_args.max_to_keep=~", f"arch.num_evaluation={windows}",
            f"arch.total_timesteps={windows * window}", *extra])
        ff_rainbow.run_experiment(config, device="cpu")

    run("unbroken", 2)
    run("first", 1)
    run("resumed", 1, ["logger.checkpointing.load_model=true",
                       "logger.checkpointing.load_args.checkpoint_uid=first"])
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == window
    load = lambda uid: torch.load(  # noqa: E731
        os.path.join(tmp_path, "checkpoints", uid, "ff_rainbow", str(2 * window), "state.pt"),
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
    assert unbroken["buffer_state/num_added"] == 4 + 2 * 2 * 4
    assert "buffer_state/priorities" in unbroken
    assert float(unbroken["buffer_state/priorities"].max()) > 0


def test_update_guard_the_reference_ignores_is_refused_naming_the_key():
    config = config_lib.compose(config_lib.default_config_dir(), ROOT,
                                TINY + ["system.update_guard=skip", "arch.num_evaluation=1"])
    with pytest.raises(NotImplementedError, match=r"system\.update_guard"):
        ff_rainbow.run_experiment(config, device="cpu")


# The JAX ff_rainbow returns 10.0 under these overrides on the CPU (seeds 42 and 1).
IDENTITY = ["env=identity_game", "arch.total_num_envs=16", "arch.num_evaluation=1",
            "arch.num_eval_episodes=32", "arch.total_timesteps=65536",
            "system.total_buffer_size=4096", "system.total_batch_size=64", "system.vmin=0.0",
            "system.vmax=10.0", "logger.use_console=False"]


def test_rainbow_learns_identity_game():
    config = config_lib.compose(config_lib.default_config_dir(), ROOT, IDENTITY)
    final_return = ff_rainbow.run_experiment(config, device="cpu")
    assert final_return > 8.0, f"ff_rainbow failed to learn IdentityGame: {final_return}"
    assert runner.LAST_RUN_STATS["device"] == "cpu"
