"""The deterministic-policy actor-critics of the PyTorch port
(stoix_tpu_torch/systems/ddpg: ff_ddpg, ff_td3, ff_d4pg) against the JAX
package's, on the CPU, at a small width (MLPs of 16 x 16 on Pendulum).

1. `update_from_batch` of each system from the JAX package's own flax
   params (the target perturbed, so it differs from the online), on an
   explicit batch: the JAX side is the package's own `update_from_batch`
   (taken from its `learner_setup`) under `jax.vmap(axis_name="batch")` and
   `jax.vmap(axis_name="data")`, jitted; TD3's smoothing normals are fed to
   both packages (`torch_parity.fed_normals`). Two or three steps (TD3: a
   policy step, an off step, a policy step, the actor's Adam count 1, 1,
   2), at `update_batch_size` 1 and 2: losses 1e-5 relative, params 1e-5
   absolute.
2. The update's generator seam: `update(..., generators)` is `step` on the
   normals drawn from the same generators; exploration acting against the
   JAX `act_in_env` on the same normals (1e-6).
3. The warm-up: `Box.sample` from given uniforms bitwise `jax.jit` of the
   JAX formula; the warm-up's buffer holds `warmup_steps` x E merged items
   whose actions are the generator's uniforms through that formula.
4. A ff_td3 resume after window 1 is bitwise the unbroken run (its count
   carried); `system.update_guard` is refused naming the key (C18); every
   system runs to a finite return at tests/test_systems_sweep.py's budget.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu import envs as jax_envs
from stoix_tpu.base_types import Transition as JaxTransition
from stoix_tpu.parallel.mesh import create_mesh
from stoix_tpu.systems import off_policy_core as jcore
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import OnlineAndTarget, Transition
from stoix_tpu_torch.envs import spaces
from stoix_tpu_torch.systems import anakin, runner
from stoix_tpu_torch.systems.ddpg import ff_ddpg, ff_td3
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from torch_parity import fed_normals, n, t, to_flax_params

BATCH = 24
SMALL = ["network.actor_network.pre_torso.layer_sizes=[16,16]",
         "network.critic_network.pre_torso.layer_sizes=[16,16]",
         "arch.total_num_envs=8", "system.total_buffer_size=512", "system.total_batch_size=64",
         "system.actor_lr=1e-3", "system.q_lr=1e-3"]
PACKAGE = {"ff_ddpg": "ddpg", "ff_td3": "ddpg", "ff_d4pg": "ddpg", "ff_sac": "sac"}
SWEEP = ["arch.total_num_envs=16", "arch.total_timesteps=2048", "arch.num_evaluation=1",
         "arch.num_eval_episodes=8", "arch.absolute_metric=False", "system.rollout_length=8",
         "logger.use_console=False", "system.total_buffer_size=4096",
         "system.total_batch_size=32"]


def configs(name, overrides=()):
    root = f"default/anakin/default_{name}.yaml"
    overrides = [*SMALL, *overrides]
    return (check_total_timesteps(config_lib.compose(config_lib.default_config_dir(), root,
                                                     overrides), 1),
            jax_config.compose(jax_config.default_config_dir(), root, overrides))


def jax_system(name, jcfg, monkeypatch):
    """The JAX package's own `update_from_batch` and `act_in_env` of `name`
    (captured from its `learner_setup` on a one-device mesh) and its initial
    params and optimizer states (one replica's)."""
    captured = {}
    original = jcore.standard_off_policy_learner

    def capture(env, buffer, config, update_from_batch, act_in_env):
        captured.update(update=update_from_batch, act=act_in_env)
        return original(env, buffer, config, update_from_batch, act_in_env)

    monkeypatch.setattr(jcore, "standard_off_policy_learner", capture)
    module = importlib.import_module(f"stoix_tpu.systems.{PACKAGE[name]}.{name}")
    env, _ = jax_envs.make(jcfg)
    mesh = create_mesh({"data": 1}, jax.devices()[:1])
    setup, _ = module.learner_setup(env, jcfg, mesh, jax.random.PRNGKey(3))
    first = jax.tree.map(lambda x: np.asarray(x)[0], (setup.learner_state.params,
                                                      setup.learner_state.opt_states))
    return captured["update"], captured["act"], first[0], first[1]


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (x + rng.normal(scale=0.05, size=x.shape)).astype(x.dtype), tree)


def batch_pair(seed, obs_dim=3, action_dim=1, size=BATCH):
    """The same Transition batch for both packages (Pendulum's shapes)."""
    from stoix_tpu.envs.types import Observation as JaxObservation
    from stoix_tpu_torch.envs.types import Observation

    rng = np.random.default_rng(seed)

    def obs():
        return (rng.normal(size=(size, obs_dim)).astype(np.float32),
                np.ones((size, action_dim), np.float32), np.zeros((size,), np.int32))

    o, o2 = obs(), obs()
    fields = dict(action=rng.uniform(-2, 2, size=(size, action_dim)).astype(np.float32),
                  reward=(rng.normal(size=size) * 3 - 5).astype(np.float32),
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


def stacked(trees):
    """[1, U, ...] leaves: the data axis of one shard, then the replicas."""
    return jax.tree.map(lambda *xs: jnp.stack(xs)[None], *trees)


def jax_steps(update, params, opt_states, batches, normals_per_step):
    """The JAX update under vmap("batch") inside vmap("data"), jitted, one
    call a step, each step's normals fed in call order."""
    u = len(batches)
    params = stacked([params] * u)
    opt_states = stacked([opt_states] * u)
    jbatch = stacked(batches)
    keys = jax.random.split(jax.random.PRNGKey(11), u)[None]
    out = []
    for normals in normals_per_step:
        # A fresh jit a step: fed normals enter the trace as constants.
        fn = jax.jit(jax.vmap(jax.vmap(update, axis_name="batch"), axis_name="data"))
        with fed_normals(normals):
            (params, opt_states), metrics = fn(params, opt_states, jbatch, keys)
        out.append((params, opt_states, jax.tree.map(np.asarray, metrics)))
    return out


def port_networks(name, cfg, actor_params, q_params):
    """The port's networks of `name` with the JAX params loaded, and apply fns."""
    module = importlib.import_module(f"stoix_tpu_torch.systems.{PACKAGE[name]}.{name}")
    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    actor, q_network, bounds = module.build_networks(env, cfg, torch.Generator())
    load_flax_params(actor, actor_params)
    load_flax_params(q_network, q_params)
    return actor, q_network, bounds


def as_port(flax_params, network):
    load_flax_params(network, flax_params)
    return {k: v.detach().clone() for k, v in network.named_parameters()}


def assert_params(port, want, like, index):
    got = to_flax_params(port, like)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w)[0, index], rtol=0, atol=1e-5)


def assert_metrics(got, want, index, keys):
    for key in keys:
        value = got[key] if got[key].dim() == 0 else got[key][index]
        np.testing.assert_allclose(n(value), want[key][0, index], rtol=1e-5, atol=1e-7)


def adam_count(state):
    """optax's Adam step count inside a chained optimizer state."""
    for leaf in jax.tree.leaves(state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return int(np.asarray(leaf.count).reshape(-1)[0])
    raise AssertionError("no Adam state")


UPDATE_CLS = {"ff_ddpg": ff_ddpg.DDPGUpdate, "ff_td3": ff_td3.TD3Update,
              "ff_d4pg": importlib.import_module("stoix_tpu_torch.systems.ddpg.ff_d4pg").D4PGUpdate}
METRICS = {"ff_ddpg": ("q_loss", "mean_q", "actor_loss"),
           "ff_td3": ("q_loss", "mean_q", "actor_loss"),
           "ff_d4pg": ("q_loss", "actor_loss")}


@pytest.mark.parametrize("update_batch", [1, 2])
@pytest.mark.parametrize("name", ["ff_ddpg", "ff_td3", "ff_d4pg"])
def test_update_from_batch_matches_jax(name, update_batch, monkeypatch):
    overrides = [f"arch.update_batch_size={update_batch}"] + (
        ["system.vmin=-50.0", "system.vmax=10.0"] if name == "ff_d4pg" else [])
    cfg, jcfg = configs(name, overrides)
    jupdate, _, jparams, jopt = jax_system(name, jcfg, monkeypatch)
    actor, q = jparams.actor_params, jparams.q_params
    jparams = jparams._replace(actor_params=actor._replace(target=perturbed(actor.target, 1)),
                               q_params=q._replace(target=perturbed(q.target, 2)))
    pairs = [batch_pair(seed) for seed in range(5, 5 + update_batch)]
    steps = 3 if name == "ff_td3" else 2
    rng = np.random.default_rng(9)
    normals = [[rng.normal(size=(BATCH, 1)).astype(np.float32)] if name == "ff_td3" else []
               for _ in range(steps)]
    want = jax_steps(jupdate, jparams, jopt, [p[0] for p in pairs], normals)

    actor, q_network, bounds = port_networks(name, cfg, jparams.actor_params.online,
                                             jparams.q_params.online)
    optims = ff_ddpg.make_optimizers(cfg)
    update = UPDATE_CLS[name](ff_ddpg.make_apply(actor), ff_ddpg.make_apply(q_network), optims,
                              cfg, bounds)
    actor_online = as_port(jparams.actor_params.online, actor)
    q_online = as_port(jparams.q_params.online, q_network)
    params = ff_ddpg.DDPGParams(
        OnlineAndTarget(actor_online, as_port(jparams.actor_params.target, actor)),
        OnlineAndTarget(q_online, as_port(jparams.q_params.target, q_network)))
    opt = update.initial_opt_states(ff_ddpg.DDPGOptStates(optims[0].init(actor_online),
                                                          optims[1].init(q_online)))
    params, opts = [params] * update_batch, [opt] * update_batch
    batches = [p[1] for p in pairs]
    for step, (wparams, wopt, wmetrics) in enumerate(want):
        noise = [torch.from_numpy(normals[step][0]) if normals[step] else None] * update_batch
        params, opts, metrics = update.step(params, opts, batches, noise)
        for u in range(update_batch):
            assert_metrics(metrics, wmetrics, u, METRICS[name])
    like_actor, like_q = jparams.actor_params.online, jparams.q_params.online
    for u in range(update_batch):
        assert_params(params[u].actor_params.online, wparams.actor_params.online, like_actor, u)
        assert_params(params[u].actor_params.target, wparams.actor_params.target, like_actor, u)
        assert_params(params[u].q_params.online, wparams.q_params.online, like_q, u)
        assert_params(params[u].q_params.target, wparams.q_params.target, like_q, u)
    if name == "ff_td3":
        # Policy steps at counts 0 and 2, an off step at 1: Adam stepped twice.
        assert opts[0].count == 3 == int(np.asarray(wopt[1]).reshape(-1)[0])
        assert opts[0].opt_states.actor_opt_state.count == 2 == adam_count(wopt[0].actor_opt_state)
        assert opts[0].opt_states.q_opt_state.count == 3 == adam_count(wopt[0].q_opt_state)


def test_td3_off_step_keeps_the_actor_and_its_adam_state_bitwise(monkeypatch):
    """On an off step (count 1 of policy_frequency 2) the actor's online
    params and optimizer state are the inputs themselves, its target moves
    by Polyak, and its loss is still reported, as JAX's masked update gives."""
    cfg, _ = configs("ff_td3")
    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    actor, q_network, bounds = ff_td3.build_networks(env, cfg, torch.Generator().manual_seed(0))
    optims = ff_ddpg.make_optimizers(cfg)
    update = ff_td3.TD3Update(ff_ddpg.make_apply(actor), ff_ddpg.make_apply(q_network), optims,
                              cfg, bounds)
    a, q = ff_ddpg.detached_params(actor), ff_ddpg.detached_params(q_network)
    params = [ff_ddpg.DDPGParams(OnlineAndTarget(a, a), OnlineAndTarget(q, q))]
    opts = [update.initial_opt_states(ff_ddpg.DDPGOptStates(optims[0].init(a),
                                                            optims[1].init(q)))]
    batch = [batch_pair(1)[1]]
    noise = [torch.zeros(BATCH, 1)]
    params, opts, _ = update.step(params, opts, batch, noise)  # a policy step
    before, before_opt = params[0].actor_params, opts[0].opt_states.actor_opt_state
    params, opts, metrics = update.step(params, opts, batch, noise)  # an off step
    assert params[0].actor_params.online is before.online
    assert opts[0].opt_states.actor_opt_state is before_opt and before_opt.count == 1
    assert all(not torch.equal(params[0].actor_params.target[k], before.target[k]) for k in a)
    assert torch.isfinite(metrics["actor_loss"]) and opts[0].count == 2


@pytest.mark.parametrize("name", ["ff_td3", "ff_sac"])
def test_update_draws_its_noise_from_the_replicas_generators(name):
    """`update(params, opts, batches, generators)` is `step` on the normals
    drawn from the same generators, each replica's from its own."""
    module = importlib.import_module(f"stoix_tpu_torch.systems.{PACKAGE[name]}.{name}")
    cfg, _ = configs(name, ["arch.update_batch_size=2"])
    setup, warmup = module.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 5)
    state = warmup(setup.learner_state)
    learner = setup.learn
    generators = list(state.generator)
    copies = [torch.Generator().set_state(g.get_state()) for g in generators]
    batches = [learner.buffer.sample(b, g).experience for b, g in zip(state.buffer_state, copies)]
    for g, c in zip(generators, copies):
        g.set_state(c.get_state())  # both sides past the samples
    noises = [learner.update_from_batch.draw_noise(b, c) for b, c in zip(batches, copies)]
    params = anakin.split_replicas(state.params, 2)
    opts = anakin.split_replicas(state.opt_states, 2)
    got = learner.update_from_batch(params, opts, batches, generators)
    want = learner.update_from_batch.step(params, opts, batches, noises)
    first = [x if name == "ff_td3" else x[0] for x in noises]
    assert not torch.equal(first[0], first[1])  # each replica's own draw
    for g, w in zip(jax.tree.leaves(got[0], is_leaf=torch.is_tensor),
                    jax.tree.leaves(want[0], is_leaf=torch.is_tensor)):
        assert torch.equal(g, w)


def test_exploration_matches_the_jax_act_in_env(monkeypatch):
    """The online actor's action plus normal . sigma . (hi - lo) / 2,
    clipped, against the JAX package's `act_in_env` on the same normals."""
    cfg, jcfg = configs("ff_ddpg", ["system.exploration_sigma=0.7"])
    _, jact, jparams, _ = jax_system("ff_ddpg", jcfg, monkeypatch)
    actor, _, bounds = port_networks("ff_ddpg", cfg, jparams.actor_params.online,
                                     jparams.q_params.online)
    act = ff_ddpg.exploration_act_fn(ff_ddpg.make_apply(actor), cfg, bounds)
    jbatch, tbatch = batch_pair(3, size=64)
    generator = torch.Generator().manual_seed(4)
    normals = torch.randn((64, 1), generator=torch.Generator().set_state(generator.get_state()))
    params = ff_ddpg.DDPGParams(OnlineAndTarget(ff_ddpg.detached_params(actor), None), None)
    got = act(params, tbatch.obs, generator, None)
    with fed_normals([normals.numpy()]):
        want = jax.jit(jact)(jparams, jbatch.obs, jax.random.PRNGKey(0))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=1e-6)
    assert float(got.min()) == -2.0 and float(got.max()) == 2.0  # sigma 0.7 reaches the clip


@pytest.mark.parametrize("env_name", ["pendulum", "mountain_car_continuous"])
def test_box_sample_from_given_uniforms_is_the_jax_formula(env_name):
    cfg = config_lib.compose(config_lib.default_config_dir(), "default/anakin/default_ff_ddpg.yaml",
                             [f"env={env_name}"])
    jcfg = jax_config.compose(jax_config.default_config_dir(),
                              "default/anakin/default_ff_ddpg.yaml", [f"env={env_name}"])
    space, jspace = envs.make(cfg)[0].action_space(), jax_envs.make(jcfg)[0].action_space()
    u = np.random.default_rng(0).random((256,) + tuple(jspace.shape)).astype(np.float32)
    low = jnp.broadcast_to(jnp.asarray(jspace.low, jnp.float32), jspace.shape)
    high = jnp.broadcast_to(jnp.asarray(jspace.high, jnp.float32), jspace.shape)
    want = jax.jit(lambda x: low + x * (high - low))(jnp.asarray(u))
    got = space.sample(None, uniform=torch.from_numpy(u))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    drawn = space.sample(torch.Generator().manual_seed(1), (1000,))
    assert drawn.shape == (1000,) + tuple(jspace.shape)
    assert float(drawn.min()) >= float(low.min()) and float(drawn.max()) < float(high.max())


def test_random_warmup_fills_merged_items_from_the_generators_uniforms():
    """`warmup_steps` steps of every env on `low + u (high - low)`, u from the
    replica's generator, added as [T.E] time-major items."""
    cfg, _ = configs("ff_ddpg", ["system.warmup_steps=5"])
    setup, warmup = ff_ddpg.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 2)
    state = setup.learner_state
    replay = torch.Generator().set_state(state.generator.get_state())
    state = warmup(state)
    space = setup.learn.env.action_space()
    want = torch.stack([space.sample(replay, (8,)) for _ in range(5)]).reshape(40, 1)
    assert state.buffer_state.num_added == 40
    assert torch.equal(state.buffer_state.experience.action[:40], want)
    assert torch.equal(state.generator.get_state(), replay.get_state())
    assert isinstance(space, spaces.Box)


def test_td3_resume_after_window_one_is_bitwise_the_unbroken_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    window = 2 * 8 * 8

    def run(uid, windows, extra=()):
        config = config_lib.compose(
            config_lib.default_config_dir(), "default/anakin/default_ff_td3.yaml", SMALL + [
                "system.rollout_length=8", "system.epochs=3", "system.warmup_steps=4",
                "arch.num_eval_episodes=4", "logger.use_console=False",
                "logger.checkpointing.save_model=true",
                f"logger.checkpointing.save_args.checkpoint_uid={uid}",
                "logger.checkpointing.save_args.max_to_keep=~",
                f"arch.num_evaluation={windows}", f"arch.total_timesteps={windows * window}",
                *extra])
        ff_td3.run_experiment(config, device="cpu")

    run("unbroken", 2)
    run("first", 1)
    run("resumed", 1, ["logger.checkpointing.load_model=true",
                       "logger.checkpointing.load_args.checkpoint_uid=first"])
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == window
    load = lambda uid: torch.load(  # noqa: E731
        os.path.join(tmp_path, "checkpoints", uid, "ff_td3", str(2 * window), "state.pt"),
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
    # 2 windows x 2 updates x 3 epochs; the actor's Adam stepped on even counts.
    assert unbroken["opt_states/count"] == 12
    assert unbroken["opt_states/opt_states/actor_opt_state/count"] == 6


@pytest.mark.parametrize("name", ["ff_ddpg", "ff_td3", "ff_d4pg"])
def test_update_guard_the_reference_ignores_is_refused_naming_the_key(name):
    module = importlib.import_module(f"stoix_tpu_torch.systems.ddpg.{name}")
    cfg, _ = configs(name, ["system.update_guard=skip"])
    with pytest.raises(NotImplementedError, match="system.update_guard"):
        module.run_experiment(cfg, device="cpu")


@pytest.mark.parametrize("name", ["ff_ddpg", "ff_td3", "ff_d4pg"])
def test_system_runs_to_a_finite_return_at_the_sweep_budget(name):
    module = importlib.import_module(f"stoix_tpu_torch.systems.ddpg.{name}")
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             f"default/anakin/default_{name}.yaml", SWEEP)
    assert np.isfinite(module.run_experiment(cfg, device="cpu"))
