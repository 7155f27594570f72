"""The value-based family of the PyTorch port (stoix_tpu_torch/systems/
q_learning, on systems/off_policy_core.py) against the JAX package's, on the
CPU.

1. One `update_from_batch` of each of the six buffer systems (dqn, ddqn,
   dqn_reg, mdqn, c51, qr_dqn) from identical online and target params, on
   an explicit batch, against the JAX package's loss composed as its
   q_family.py composes it (value_and_grad, clip + Adam eps 1e-5,
   `optax.incremental_update`): the loss 1e-5 relative, online and target
   params 1e-5 absolute (gradients reduce in another order than XLA's).
2. The same step at `arch.update_batch_size` 2 against JAX's composition
   under `jax.vmap(axis_name="batch")` with the gradients' pmean: 1e-5 as above.
3. The warmup fill on fixed actions against JAX's warmup body (env steps,
   `make_transition`, the time-major merge and the item buffer's add) on
   CartPole from the same states: the buffer exact but the physics
   (1e-5, as tests/test_torch_envs.py).
4. The epsilon schedule against JAX's float32 formula (exact), its
   ValueError, `system.replay.impl=sharded` building the sharded facade and
   `replay.prioritized` on it refused naming the key, and the divergence
   guard (skip, halt) keeping the pre-update state.
5. ff_pqn's update step (Q(lambda) targets once over [T, E], epochs x
   minibatches of clip + RAdam and the step counter) against JAX's
   composition with the same permutations: targets 1e-6 absolute (the
   network's max Q in another summation order), params 1e-5 absolute; at
   U = 2 one `linear_recurrence_reverse` call an update.
6. A resume of ff_dqn after window 1 is bitwise the unbroken run, its
   buffers included.
7. Learning oracles on IdentityGame, above 8.0 as the JAX package reaches
   10.0: ff_dqn with the overrides the JAX package learns with at 16384
   steps, and ff_pqn at 32768 steps (decay off, 2 minibatches): on the CPU
   at 16384 steps the JAX package itself ends below 8.0 on two of the seeds
   42, 0, 1, 2 (7.29, 5.10) and the port on one (7.63 at the default seed
   42), while at 32768 both return 10.0 on all four.
8. Every system runs one window to a finite return at the sweep's tiny
   budget (tests/test_systems_sweep.py).
"""

import importlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu.base_types import OnlineAndTarget as JaxOnlineAndTarget
from stoix_tpu.base_types import Transition as JaxTransition
from stoix_tpu.buffers import make_item_buffer as jax_make_item_buffer
from stoix_tpu.envs import classic as jclassic
from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.ops import multistep as jmultistep
from stoix_tpu.systems import off_policy_core as jcore
from stoix_tpu.systems.q_learning import ff_pqn as jax_pqn
from stoix_tpu.utils import config as jax_config
from stoix_tpu.utils.jax_utils import tree_merge_leading_dims as jax_merge
from stoix_tpu_torch.base_types import OffPolicyLearnerState, OnlineAndTarget, Transition
from stoix_tpu_torch.buffers import ItemBufferState
from stoix_tpu_torch.envs import classic, wrappers
from stoix_tpu_torch.envs.types import Observation, TimeStep
from stoix_tpu_torch.ops import scan_kernels
from stoix_tpu_torch.systems import off_policy_core as core, runner
from stoix_tpu_torch.systems.q_learning import ff_dqn, ff_pqn, q_family
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam, ClipRAdam
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_envs import _cartpole_state_to_port, _jax_env
from test_torch_q_ops import paired_q_networks
from torch_parity import n, t, to_flax_params

OBS_DIM, ACTIONS, BATCH = 5, 3, 32


@pytest.fixture(autouse=True)
def one_thread():
    # The suite runs several workers side by side, and these runs are small.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
SYSTEMS = ["dqn", "ddqn", "dqn_reg", "mdqn", "c51", "qr_dqn"]
HEAD_KIND = {"c51": "c51", "qr_dqn": "qr"}


def _configs(name, overrides=()):
    root = f"default/anakin/default_ff_{name}.yaml"
    overrides = ["env=identity_game", *overrides]
    return (config_lib.compose(config_lib.default_config_dir(), root, overrides),
            jax_config.compose(jax_config.default_config_dir(), root, overrides))


def _batch(seed, size=BATCH):
    rng = np.random.default_rng(seed)

    def obs():
        return (rng.normal(size=(size, OBS_DIM)).astype(np.float32),
                np.ones((size, ACTIONS), np.float32), np.zeros((size,), np.int32))

    o, o2 = obs(), obs()
    fields = dict(action=rng.integers(0, ACTIONS, size).astype(np.int32),
                  reward=rng.normal(size=size).astype(np.float32) * 3,
                  done=rng.random(size) < 0.2)
    info = {"episode_return": np.zeros(size, np.float32),
            "episode_length": np.zeros(size, np.int32),
            "is_terminal_step": np.zeros(size, bool)}
    jax_batch = JaxTransition(JaxObservation(*map(jnp.asarray, o)),
                              *(jnp.asarray(fields[k]) for k in ("action", "reward", "done")),
                              JaxObservation(*map(jnp.asarray, o2)),
                              jax.tree.map(jnp.asarray, info))
    port_batch = Transition(Observation(*map(t, o)),
                            *(t(fields[k]) for k in ("action", "reward", "done")),
                            Observation(*map(t, o2)), {k: t(v) for k, v in info.items()})
    return jax_batch, port_batch


def _system_pair(name):
    """(jax module, port module) of one system."""
    return (importlib.import_module(f"stoix_tpu.systems.q_learning.ff_{name}"),
            importlib.import_module(f"stoix_tpu_torch.systems.q_learning.ff_{name}"))


def _loss_fns(name):
    jmod, tmod = _system_pair(name)
    attr = {"dqn": "dqn_loss", "ddqn": "ddqn_loss", "dqn_reg": "dqn_reg_loss",
            "mdqn": "mdqn_loss", "c51": "c51_loss", "qr_dqn": "qr_dqn_loss"}[name]
    return getattr(jmod, attr), getattr(tmod, attr)


def _networks(name):
    """The flax net with online and target params, and the port net with the
    same two as {name: tensor} dicts."""
    kind = HEAD_KIND.get(name, "dqn")
    jax_net, online, torch_net = paired_q_networks(kind, seed=1)
    target = jax.tree.map(np.asarray, jax_net.init(jax.random.PRNGKey(2), jax.tree.map(
        lambda x: x[:1], _batch(0)[0].obs)))
    port_online = {k: v.detach().clone() for k, v in torch_net.named_parameters()}
    load_flax_params(torch_net, target)
    port_target = {k: v.detach().clone() for k, v in torch_net.named_parameters()}
    return jax_net, online, target, torch_net, port_online, port_target


def _jax_update(loss_fn, q_apply, config, optim, axis=None):
    tau = float(config.system.tau)

    def update(params, opt_state, batch):
        def wrapped(online):
            return loss_fn(online, params.target, batch, q_apply, config)

        (loss, _), grads = jax.value_and_grad(wrapped, has_aux=True)(params.online)
        if axis is not None:
            grads = jax.lax.pmean(grads, axis_name=axis)
        updates, opt_state = optim.update(grads, opt_state)
        online = optax.apply_updates(params.online, updates)
        return (JaxOnlineAndTarget(online, optax.incremental_update(online, params.target, tau)),
                opt_state), loss

    return update


def _port_update(name, cfg, torch_net, loss_fn):
    optim = ClipAdam(float(cfg.system.q_lr), float(cfg.system.max_grad_norm), eps=1e-5)
    return q_family.QUpdate(loss_fn, q_family.make_q_apply(torch_net), optim, cfg), optim


def _jax_optim(jcfg):
    return optax.chain(optax.clip_by_global_norm(float(jcfg.system.max_grad_norm)),
                       optax.adam(float(jcfg.system.q_lr), eps=1e-5))


def _assert_params(port, want, like):
    got = to_flax_params(port, like)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", SYSTEMS)
def test_update_from_batch_matches_jax(name):
    cfg, jcfg = _configs(name)
    jax_loss, port_loss = _loss_fns(name)
    jax_net, online, target, torch_net, port_online, port_target = _networks(name)
    jbatch, tbatch = _batch(3)
    optim = _jax_optim(jcfg)
    params = JaxOnlineAndTarget(online, target)
    update = jax.jit(_jax_update(jax_loss, jax_net.apply, jcfg, optim))
    state = optim.init(online)
    update_fn, port_optim = _port_update(name, cfg, torch_net, port_loss)
    tparams, topt = [OnlineAndTarget(port_online, port_target)], [port_optim.init(port_online)]
    for step in range(2):  # the second step reads Adam's moments and a moved target
        (params, state), loss = update(params, state, jbatch)
        tparams, topt, info = update_fn(tparams, topt, [tbatch])
        np.testing.assert_allclose(n(info["q_loss"]), np.asarray(loss), rtol=1e-5)
    _assert_params(tparams[0].online, params.online, online)
    _assert_params(tparams[0].target, params.target, online)
    assert topt[0].count == 2


@pytest.mark.parametrize("mode", ["skip", "halt"])
def test_divergence_guard_keeps_the_pre_update_state(mode):
    # system.update_guard under a poisoned loss (NaN, and NaN gradients): the
    # online and target params and Adam's moments stay as they were, the step
    # count advances (as the PPO guard's, tests/test_torch_ppo_knobs.py), and
    # the flag reaches the metrics the runner's host half reads.
    cfg, _ = _configs("dqn", [f"system.update_guard={mode}"])
    _, port_loss = _loss_fns("dqn")
    *_, torch_net, port_online, port_target = _networks("dqn")

    def poisoned(*args):
        loss, info = port_loss(*args)
        return loss * float("nan"), info

    update_fn, optim = _port_update("dqn", cfg, torch_net, poisoned)
    params = [OnlineAndTarget(port_online, port_target)]
    opt = [optim.init(port_online)]
    new_params, new_opt, info = update_fn(params, opt, [_batch(7)[1]])
    assert float(info["skipped_updates"]) == 1.0
    for side in (0, 1):
        assert all(torch.equal(new_params[0][side][k], params[0][side][k])
                   for k in port_online)
    assert all(torch.equal(new_opt[0].mu[k], opt[0].mu[k]) for k in port_online)


def test_update_batch_of_two_matches_jax_vmap():
    cfg, jcfg = _configs("dqn", ["arch.update_batch_size=2"])
    jax_loss, port_loss = _loss_fns("dqn")
    jax_net, online, target, torch_net, port_online, port_target = _networks("dqn")
    batches = [_batch(s) for s in (4, 5)]
    optim = _jax_optim(jcfg)
    stack = lambda *xs: jax.tree.map(lambda *a: jnp.stack(a), *xs)  # noqa: E731
    params = stack(*[JaxOnlineAndTarget(online, target)] * 2)
    state = stack(*[optim.init(online)] * 2)
    update = jax.jit(jax.vmap(_jax_update(jax_loss, jax_net.apply, jcfg, optim, axis="batch"),
                              axis_name="batch"))
    (params, state), loss = update(params, state, stack(*(b[0] for b in batches)))
    update_fn, port_optim = _port_update("dqn", cfg, torch_net, port_loss)
    tparams, _, info = update_fn([OnlineAndTarget(port_online, port_target)] * 2,
                                 [port_optim.init(port_online)] * 2, [b[1] for b in batches])
    np.testing.assert_allclose(n(info["q_loss"]), np.asarray(loss), rtol=1e-5)
    for u in range(2):
        _assert_params(tparams[u].online, jax.tree.map(lambda x: x[u], params.online), online)
        _assert_params(tparams[u].target, jax.tree.map(lambda x: x[u], params.target), online)


def test_warmup_fill_on_fixed_actions_matches_jax(monkeypatch):
    cfg, _ = _configs("dqn", ["env=cartpole", "arch.total_num_envs=16",
                              "system.warmup_steps=5", "system.total_buffer_size=64"])
    cfg.system.action_dim = 2
    actions = np.random.default_rng(6).integers(0, 2, (5, 16)).astype(np.int32)
    jenv, (jstate, jts) = _jax_env(jclassic.CartPole())
    # The port starts from the same CartPole states and first timestep.
    tenv = wrappers.apply_core_wrappers(classic.CartPole())
    gen = torch.Generator().manual_seed(0)
    start = OffPolicyLearnerState(None, None, None, gen, _cartpole_state_to_port(jstate, gen),
                                  _port_timestep(jts))
    # JAX: its warmup body (q_family.get_discrete_warmup_fn) with the fixed actions.
    jbuf = jax_make_item_buffer(64, 16, 16, 80)
    steps, ts = [], jts
    for a in actions:
        jstate, next_ts = jenv.step(jstate, jnp.asarray(a))
        steps.append(jcore.make_transition(ts, jnp.asarray(a), next_ts))
        ts = next_ts
    want = jbuf.add(jbuf.init(jcore.dummy_transition(jenv, discrete_actions=True)),
                    jax_merge(jax.tree.map(lambda *x: jnp.stack(x), *steps), 2))
    # The port: its warmup with the same actions in place of its draws.
    buffer, buffer_state = core.build_buffer(tenv, cfg, "cpu", discrete_actions=True)
    draws = iter(actions)
    monkeypatch.setattr(q_family.torch, "randint",
                        lambda low, high, size, generator, device: t(next(draws)).long())
    cfg.arch.num_updates_per_eval = 1
    learner = core.OffPolicyLearner(tenv, buffer, cfg, update_from_batch=None, act_in_env=None)
    got = q_family.get_discrete_warmup_fn(learner, cfg)(
        start._replace(buffer_state=buffer_state)).buffer_state
    monkeypatch.undo()
    assert (got.insert_pos, got.num_added) == (int(want.insert_pos), int(want.num_added)) == (
        80 % 64, 80)
    for g, w in zip(tree_leaves(got.experience), jax.tree.leaves(want.experience)):
        np.testing.assert_allclose(n(g).astype(np.float64), np.asarray(w).astype(np.float64),
                                   rtol=0, atol=1e-5)


def _port_timestep(jts):
    """The port's TimeStep of a JAX timestep's values."""
    obs = lambda o: Observation(*(t(x) for x in o))  # noqa: E731
    extras = {"episode_metrics": {k: t(v) for k, v in jts.extras["episode_metrics"].items()},
              "next_obs": obs(jts.extras["next_obs"]), "truncation": t(jts.extras["truncation"])}
    return TimeStep(t(jts.step_type), t(jts.reward), t(jts.discount), obs(jts.observation),
                    extras)


def test_epsilon_schedule_matches_jax_and_refuses_a_decay_that_changes_nothing():
    cfg, _ = _configs("dqn")
    epsilon = q_family.epsilon_schedule(cfg)
    for added in (0, 1, 4096, 12345, 25000, 90000):
        frac = jnp.minimum(jnp.int32(added).astype(jnp.float32) / 25000.0, 1.0)
        want = 0.1 + frac * (0.02 - 0.1)
        assert np.float32(epsilon(ItemBufferState(None, 0, added))) == np.asarray(want)
    cfg.system.final_epsilon = cfg.system.training_epsilon
    with pytest.raises(ValueError, match="final_epsilon equals"):
        q_family.epsilon_schedule(cfg)


def test_sharded_replay_is_refused_naming_the_key():
    """`system.replay.impl=sharded` builds the facade over the sharded core
    (one process: one shard of the whole ring, the whole batch; sampling
    waits for a batch's worth), and `replay.prioritized` on it is still
    refused, naming the key, with the JAX package's message."""
    from stoix_tpu_torch.replay.compat import ShardedItemBuffer

    env = wrappers.apply_core_wrappers(classic.CartPole())
    cfg, _ = _configs("dqn", ["system.replay.impl=sharded", "system.total_buffer_size=64",
                              "system.total_batch_size=16"])
    cfg.system.action_dim = 2
    buffer, state = core.build_buffer(env, cfg, "cpu", True)
    assert isinstance(buffer, ShardedItemBuffer)
    assert tuple(state.priorities.shape) == (64,) and not buffer.can_sample(state)
    items = tree_map(lambda x: x.expand((16,) + tuple(x.shape)).clone(),
                          core.dummy_transition(env, True))
    state = buffer.add(state, items)
    assert buffer.can_sample(state)
    assert buffer.sample(state, torch.Generator().manual_seed(0)).experience.reward.shape == (16,)
    cfg, _ = _configs("dqn", ["system.replay.impl=sharded", "system.replay.prioritized=true"])
    cfg.system.action_dim = 2
    with pytest.raises(ValueError, match=r"system\.replay\.prioritized=true .*set_priorities"):
        core.build_buffer(env, cfg, "cpu", True)


# ----------------------------------------------------------------- PQN


def _pqn_trajectory(seed, t_len=4, envs=8):
    rng = np.random.default_rng(seed)

    def obs():
        return (rng.normal(size=(t_len, envs, OBS_DIM)).astype(np.float32),
                np.ones((t_len, envs, ACTIONS), np.float32),
                np.zeros((t_len, envs), np.int32))

    discount = (rng.random((t_len, envs)) > 0.2).astype(np.float32)
    return dict(obs=obs(), next_obs=obs(),
                action=rng.integers(0, ACTIONS, (t_len, envs)).astype(np.int32),
                reward=rng.normal(size=(t_len, envs)).astype(np.float32),
                discount=discount,
                truncated=(rng.random((t_len, envs)) < 0.2) & (discount != 0))


def _pqn_config(overrides=()):
    return _configs("pqn", ["system.epochs=2", "system.num_minibatches=2",
                            "arch.num_updates=4", "arch.num_updates_per_eval=1",
                            "system.q_lr=5e-3", *overrides])


def test_pqn_update_step_matches_jax():
    cfg, jcfg = _pqn_config()
    jax_net, params, torch_net = paired_q_networks("dqn", use_layer_norm=True, seed=3)
    traj = _pqn_trajectory(0)
    perms = [np.random.default_rng(10 + e).permutation(32) for e in range(2)]
    # JAX: ff_pqn's _update_step after the rollout, with the given permutations.
    jobs = JaxObservation(*map(jnp.asarray, traj["obs"]))
    jnext = JaxObservation(*map(jnp.asarray, traj["next_obs"]))
    q_next = jax_net.apply(params, jnext, 0.0).preferences
    lam_t = 0.95 * (1.0 - jnp.asarray(traj["truncated"]).astype(jnp.float32))
    targets = jax.jit(lambda *a: jmultistep.q_lambda(*a, batch_major=False, impl="scan"))(
        jnp.asarray(traj["reward"]), 0.99 * jnp.asarray(traj["discount"]), q_next, lam_t)
    optim = optax.chain(optax.clip_by_global_norm(0.5), optax.radam(5e-3),
                        jax_pqn.count_gradient_steps())
    state = optim.init(params)

    def loss_fn(p, obs, action, target):
        q = jax_net.apply(p, obs, 0.0).preferences
        qa = jnp.take_along_axis(q, action[..., None], axis=-1)[..., 0]
        return 0.5 * jnp.mean((qa - target) ** 2)

    step = jax.jit(lambda p, s, *b: _radam_step(optim, loss_fn, p, s, *b))
    flat = jax_merge((jobs, jnp.asarray(traj["action"]), targets), 2)
    jparams = params
    for perm in perms:
        shuffled = jax.tree.map(lambda x: x[perm].reshape((2, -1) + x.shape[1:]), flat)
        for i in range(2):
            jparams, state = step(jparams, state, *jax.tree.map(lambda x: x[i], shuffled))
    # The port.
    q_apply = q_family.make_q_apply(torch_net)
    optim_t = ClipRAdam(5e-3, 0.5)
    learner = ff_pqn.PQNLearner(None, q_apply, optim_t, cfg)
    tparams = {k: v.detach() for k, v in torch_net.named_parameters()}
    ttraj = ff_pqn.PQNTransition(
        Observation(*map(t, traj["obs"])), t(traj["action"]), t(traj["reward"]),
        t(traj["discount"]), t(traj["truncated"]), Observation(*map(t, traj["next_obs"])), {})
    got_params, got_opt, info, got_targets = learner.update(
        tparams, (optim_t.init(tparams), ff_pqn.PQNStepCount(0)), ttraj, None,
        permutations=[t(p) for p in perms])
    np.testing.assert_allclose(n(got_targets), np.asarray(targets), rtol=0, atol=1e-6)
    _assert_params(got_params, jparams, params)
    assert ff_pqn.find_step_count(got_opt) == 4 == int(jax_pqn._find_step_count(state))
    assert n(info["q_loss"]).shape == (2, 2)


def _radam_step(optim, loss_fn, params, state, obs, action, target):
    grads = jax.grad(loss_fn)(params, obs, action, target)
    updates, state = optim.update(grads, state)
    return optax.apply_updates(params, updates), state


def test_pqn_epsilon_anneals_from_the_step_count_as_jax():
    cfg, _ = _pqn_config(["system.decay_epsilon=true", "system.exploration_fraction=0.5"])
    learner = ff_pqn.PQNLearner(None, None, None, cfg)
    for count in (0, 1, 3, 4, 8, 100):
        frac = jnp.minimum(jnp.int32(count).astype(jnp.float32) / 4 / 2.0, 1.0)
        want = 1.0 + frac * (0.1 - 1.0)
        got = learner.epsilon((None, ff_pqn.PQNStepCount(count)))
        assert np.float32(got) == np.asarray(want)


def test_pqn_runs_one_recurrence_an_update_at_update_batch_two(monkeypatch):
    calls = []
    original = scan_kernels.linear_recurrence_reverse
    monkeypatch.setattr(scan_kernels, "linear_recurrence_reverse",
                        lambda *a, **k: calls.append(a[1].shape) or original(*a, **k))
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/anakin/default_ff_pqn.yaml", SWEEP + [
                                    "env=identity_game", "arch.update_batch_size=2",
                                    "system.multistep_impl=pallas",
                                    "system.num_minibatches=2", "arch.num_evaluation=1"])
    assert math.isfinite(ff_pqn.run_experiment(config, device="cpu"))
    updates = int(config.arch.num_updates)
    assert calls == [(8, 16)] * updates  # [T, U.E] once an update


# ----------------------------------------------------------------- runs

TINY = ["env=identity_game", "arch.total_num_envs=8", "arch.num_updates_per_eval=2",
        "arch.num_eval_episodes=4", "arch.absolute_metric=False", "system.rollout_length=4",
        "system.epochs=2", "system.warmup_steps=2", "system.total_buffer_size=256",
        "system.total_batch_size=16", "logger.use_console=False"]


def test_dqn_resume_after_window_one_is_bitwise_the_unbroken_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    window = 2 * 4 * 8

    def run(uid, windows, extra=()):
        config = config_lib.compose(config_lib.default_config_dir(),
                                    "default/anakin/default_ff_dqn.yaml", TINY + [
                                        "logger.checkpointing.save_model=true",
                                        f"logger.checkpointing.save_args.checkpoint_uid={uid}",
                                        "logger.checkpointing.save_args.max_to_keep=~",
                                        f"arch.num_evaluation={windows}",
                                        f"arch.total_timesteps={windows * window}", *extra])
        ff_dqn.run_experiment(config, device="cpu")

    run("unbroken", 2)
    run("first", 1)
    run("resumed", 1, ["logger.checkpointing.load_model=true",
                       "logger.checkpointing.load_args.checkpoint_uid=first"])
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == window
    load = lambda uid: torch.load(  # noqa: E731
        os.path.join(tmp_path, "checkpoints", uid, "ff_dqn", str(2 * window), "state.pt"),
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
    assert unbroken["buffer_state/num_added"] == 2 * 8 + 2 * window
    assert {k.split("/")[0] for k in unbroken} == {
        "params", "opt_states", "buffer_state", "generator", "env_state", "timestep"}


BASE = ["env=identity_game", "arch.total_num_envs=16", "arch.num_evaluation=1",
        "arch.num_eval_episodes=32", "logger.use_console=False"]


def test_dqn_learns_identity_game():
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/anakin/default_ff_dqn.yaml", BASE + [
                                    "arch.total_timesteps=16384", "system.total_buffer_size=4096",
                                    "system.total_batch_size=64"])
    assert ff_dqn.run_experiment(config, device="cpu") > 8.0


def test_pqn_learns_identity_game():
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/anakin/default_ff_pqn.yaml", BASE + [
                                    "arch.total_timesteps=32768", "system.decay_epsilon=false",
                                    "system.num_minibatches=2"])
    assert ff_pqn.run_experiment(config, device="cpu") > 8.0


SWEEP = ["arch.total_num_envs=16", "arch.total_timesteps=2048", "arch.num_eval_episodes=8",
         "arch.absolute_metric=False", "system.rollout_length=8", "logger.use_console=False"]
BUFFER = ["system.total_buffer_size=4096", "system.total_batch_size=32"]


@pytest.mark.parametrize("name,extra", [
    ("dqn", BUFFER), ("ddqn", BUFFER), ("dqn_reg", BUFFER), ("mdqn", BUFFER),
    ("c51", ["system.vmin=0.0", "system.vmax=10.0"] + BUFFER), ("qr_dqn", BUFFER), ("pqn", []),
])
def test_every_system_runs_a_window_at_the_sweep_budget(name, extra):
    _, module = _system_pair(name)
    config = config_lib.compose(config_lib.default_config_dir(),
                                f"default/anakin/default_ff_{name}.yaml",
                                SWEEP + ["env=identity_game", "arch.num_evaluation=1"] + extra)
    assert math.isfinite(module.run_experiment(config, device="cpu"))
    assert runner.LAST_RUN_STATS["device"] == "cpu"
