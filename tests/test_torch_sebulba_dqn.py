"""Sebulba ff_dqn of the PyTorch port (stoix_tpu_torch/systems/q_learning/
sebulba/ff_dqn.py) against the JAX package's, on the CPU.

1. One learn step (2 epochs: sample the service, the Q-learning loss, the
   shards' gradients meaned, clip + Adam eps 1e-5, Polyak target) on 1 and
   2 shards, uniform and prioritized, against the JAX package's own
   `get_dqn_learn_step` (jit + shard_map over a 1- or 2-device mesh), from
   the same ring, params and uniforms (JAX's replicated key's draws): the
   losses and mean Q 1e-5 relative, online and target params 1e-5 absolute,
   the ring's priorities afterwards 1e-6 relative (XLA's float32 pow).
2. The 2-shard gradient is the shards' MEAN (ROADMAP C26: the JAX learn
   step's shard_map runs with check_vma=False): with plain SGD at rate 1 on
   both sides the params move by minus the mean of the shards' gradients,
   as JAX's do, and not by minus their sum.
3. End to end at tests/test_replay.py's budget (IdentityGame, 8 envs, two
   actor threads, every role on device 0): uniform, prioritized, and with
   the injected `actor_crash:2`, which the supervisor restarts while the
   learner goes on; the replay ledger; `replay.impl=local` and a chunk that
   does not divide over the learner devices refused with the JAX messages.
4. The IdentityGame oracle (chip_smoke.SEBULBA_DQN_IDENTITY) above 8.0; the
   JAX package returns 10.0 for seeds 42 and 1 (about 10 s on one thread).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stoix_tpu.base_types import OnlineAndTarget as JOnlineAndTarget
from stoix_tpu.base_types import Transition as JTransition
from stoix_tpu.envs.types import Observation as JObservation
from stoix_tpu.replay import ShardedReplayService as JaxService
from stoix_tpu.systems.q_learning.sebulba import ff_dqn as jdqn
from stoix_tpu.utils import config as jax_config
from stoix_tpu.utils.training import make_learning_rate as jax_lr
from stoix_tpu_torch.base_types import OnlineAndTarget, Transition
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.observability import get_registry
from stoix_tpu_torch.replay import ShardedReplayService
from stoix_tpu_torch.resilience import faultinject
from stoix_tpu_torch.systems.anakin import make_generator
from stoix_tpu_torch.systems.q_learning.q_family import make_q_apply
from stoix_tpu_torch.systems.q_learning.sebulba import ff_dqn
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam, make_learning_rate
from test_torch_q_ops import ACTIONS, OBS_DIM, paired_q_networks
from torch_parity import n, t, to_flax_params

import chip_smoke

ROOT = "default/sebulba/default_ff_dqn.yaml"
CAPACITY, BATCH = 48, 32


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    faultinject.reset()
    yield
    faultinject.reset()
    torch.set_num_threads(threads)


def configs(overrides):
    overrides = ["system.epochs=2", f"system.total_batch_size={BATCH}", *overrides]
    return (config_lib.compose(config_lib.default_config_dir(), ROOT, overrides),
            jax_config.compose(jax_config.default_config_dir(), ROOT, overrides))


def transitions(seed, size):
    rng = np.random.default_rng(seed)

    def obs():
        return (rng.normal(size=(size, OBS_DIM)).astype(np.float32),
                np.ones((size, ACTIONS), np.float32), np.zeros((size,), np.int32))

    return dict(obs=obs(), next_obs=obs(), action=rng.integers(0, ACTIONS, size).astype(np.int32),
                reward=(rng.normal(size=size) * 2).astype(np.float32),
                done=rng.random(size) < 0.2)


def jax_item():
    o = JObservation(jnp.zeros((OBS_DIM,)), jnp.zeros((ACTIONS,)), jnp.zeros((), jnp.int32))
    return JTransition(obs=o, action=jnp.zeros((), jnp.int32), reward=jnp.zeros(()),
                       done=jnp.zeros((), bool), next_obs=o, info={})


def port_item():
    o = Observation(torch.zeros(OBS_DIM), torch.zeros(ACTIONS), torch.zeros((), dtype=torch.int32))
    return Transition(obs=o, action=torch.zeros((), dtype=torch.int32), reward=torch.zeros(()),
                      done=torch.zeros((), dtype=torch.bool), next_obs=o, info={})


def as_jax(b):
    return JTransition(obs=JObservation(*map(jnp.asarray, b["obs"])),
                       action=jnp.asarray(b["action"]), reward=jnp.asarray(b["reward"]),
                       done=jnp.asarray(b["done"]),
                       next_obs=JObservation(*map(jnp.asarray, b["next_obs"])), info={})


def as_port(b, cut=slice(None)):
    return Transition(obs=Observation(*(t(x[cut]) for x in b["obs"])),
                      action=t(b["action"][cut]), reward=t(b["reward"][cut]),
                      done=t(b["done"][cut]),
                      next_obs=Observation(*(t(x[cut]) for x in b["next_obs"])), info={})


def filled_services(devices, shards, prioritized):
    """JAX's service and the port's over `shards` shards, each holding the
    same 5 adds (80 items a shard: the rings wrap)."""
    mesh = Mesh(np.asarray(devices[:shards]), ("data",))
    jsvc = JaxService(mesh, jax_item(), capacity_per_shard=CAPACITY, sample_batch_size=BATCH,
                      prioritized=prioritized)
    svc = ShardedReplayService(["cpu"] * shards, port_item(), capacity_per_shard=CAPACITY,
                               sample_batch_size=BATCH, prioritized=prioritized)
    for i in range(5):
        b = transitions(i, 16 * shards)
        jsvc.add(jax.device_put(as_jax(b), NamedSharding(mesh, P("data"))))
        svc.add([as_port(b, slice(16 * k, 16 * (k + 1))) for k in range(shards)])
    return mesh, jsvc, svc


def epoch_uniforms(key, epochs):
    """The uniforms JAX's learn step draws from its replicated key, one set
    an epoch."""
    out = []
    for _ in range(epochs):
        key, sample_key = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.uniform(sample_key, (BATCH,)))))
    return out


class SGD:
    """Plain gradient descent: `params - lr * grads` (optax.sgd's updates)."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return ()

    def update(self, grads, state):
        return {k: -self.lr * g for k, g in grads.items()}, state


def steps(cfg, jcfg, devices, shards, prioritized, sgd=False):
    """(port new state, port replay, port metrics, JAX new state, JAX
    metrics, JAX service, flax params, port learn step) of one learn step."""
    mesh, jsvc, svc = filled_services(devices, shards, prioritized)
    jax_net, params, torch_net = paired_q_networks("dqn", seed=2)
    target = jax.tree.map(lambda x: np.asarray(x) * 0.5, params)
    if sgd:
        jopt, popt = optax.sgd(1.0), SGD(1.0)
    else:
        lr = jax_lr(float(jcfg.system.q_lr), jcfg, int(jcfg.system.epochs))
        jopt = optax.chain(optax.clip_by_global_norm(float(jcfg.system.max_grad_norm)),
                           optax.adam(lr, eps=1e-5))
        popt = ClipAdam(make_learning_rate(float(cfg.system.q_lr), cfg, int(cfg.system.epochs)),
                        float(cfg.system.max_grad_norm), eps=1e-5)
    key = jax.random.PRNGKey(8)
    jstate = jax.device_put(jdqn.DQNLearnerState(JOnlineAndTarget(params, target),
                                                 jopt.init(params), key),
                            NamedSharding(mesh, P()))
    step = jdqn.get_dqn_learn_step(jax_net.apply, jopt.update, jcfg, mesh, jsvc)
    jnew, jreplay, jmetrics = step(jstate, jsvc.state)
    jsvc.commit(jreplay)

    online = {k: v.detach().clone() for k, v in torch_net.named_parameters()}
    from stoix_tpu_torch.utils.params import load_flax_params

    load_flax_params(torch_net, target)
    port_target = {k: v.detach().clone() for k, v in torch_net.named_parameters()}
    learn = ff_dqn.get_dqn_learn_step(make_q_apply(torch_net), popt, cfg, svc)
    state = ff_dqn.DQNLearnerState(OnlineAndTarget(online, port_target), popt.init(online),
                                   make_generator(0, torch.device("cpu")))
    new, replay, metrics = learn(state, svc.state, uniforms=epoch_uniforms(key, 2))
    return new, replay, metrics, jnew, jmetrics, jsvc, params, learn, state


@pytest.mark.parametrize("prioritized", [False, True])
@pytest.mark.parametrize("shards", [1, 2])
def test_learn_step_matches_jax(shards, prioritized, devices):
    cfg, jcfg = configs([f"system.replay.prioritized={prioritized}"])
    new, replay, metrics, jnew, jmetrics, jsvc, params, *_ = steps(cfg, jcfg, devices, shards,
                                                                   prioritized)
    for k in ("q_loss", "mean_q"):
        np.testing.assert_allclose(n(metrics[k]), np.asarray(jmetrics[k]), rtol=1e-5, err_msg=k)
    for side in ("online", "target"):
        got = to_flax_params(getattr(new.params, side), params)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(getattr(jnew.params, side))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.stack([n(s.priorities) for s in replay]),
                               np.asarray(jsvc.state.priorities), rtol=1e-6)


def test_two_shard_gradients_are_meaned_as_jax(devices):
    """ROADMAP C26, with plain SGD at rate 1 on both sides (one epoch): the
    port's params move by minus the MEAN of the two shards' gradients, as
    JAX's do; a sum would move them twice as far."""
    cfg, jcfg = configs(["system.epochs=1"])
    new, _, _, jnew, _, _, params, learn, state = steps(cfg, jcfg, devices, 2, False, sgd=True)
    got = to_flax_params(new.params.online, params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jnew.params.online)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    # The same draw again, each shard's gradients alone.
    replay = filled_services(devices, 2, False)[2]
    drawn = learn.core.sample_from_uniforms(replay.state, epoch_uniforms(jax.random.PRNGKey(8),
                                                                         1)[0])
    grads = [learn.shard_loss(state.params, d.experience, torch.ones(BATCH // 2))[0]
             for d in drawn]
    for name, start in state.params.online.items():
        moved = start - new.params.online[name]
        mean = (grads[0][name] + grads[1][name]) / 2
        torch.testing.assert_close(moved, mean, rtol=1e-5, atol=1e-6)
        if float(mean.abs().max()) > 1e-3:
            assert not torch.allclose(moved, 2 * mean, rtol=1e-2, atol=0.0), name


# ----------------------------------------------------------------- end to end

BASE = ["env=identity_game", "arch.total_num_envs=8", "arch.total_timesteps=1024",
        "arch.num_evaluation=1", "arch.num_eval_episodes=8", "system.rollout_length=8",
        "system.total_buffer_size=4096", "system.total_batch_size=64",
        "system.replay.min_fill=128", "arch.actor.device_ids=[0]",
        "arch.actor.actor_per_device=2", "arch.learner.device_ids=[0]",
        "arch.evaluator_device_id=0", "logger.use_console=False"]


def compose(overrides):
    return config_lib.compose(config_lib.default_config_dir(), ROOT, [*BASE, *overrides])


@pytest.mark.parametrize("case", ["uniform", "prioritized", "actor_crash", "two_learners"])
def test_runs_end_to_end(case, monkeypatch):
    overrides = {"uniform": [], "prioritized": ["system.replay.prioritized=true"],
                 "actor_crash": [],
                 "two_learners": ["arch.learner.device_ids=[1,2]"]}[case]
    if case == "actor_crash":
        monkeypatch.setenv("STOIX_TPU_FAULT", "actor_crash:2")
    injected = get_registry().counter(faultinject.FAULTS_INJECTED)
    before = injected.value(labels={"fault": "actor_crash"})
    ret = ff_dqn.run_experiment(compose(overrides), device="cpu")
    stats = dict(ff_dqn.LAST_RUN_STATS)
    assert math.isfinite(ret)
    updates = 1024 // 64
    assert stats["learn_steps"] == updates
    replay = stats["replay"]
    assert replay["added_items"] >= 128 and replay["sample_ops"] == 8 * updates
    assert replay["sampled_items"] == 8 * updates * 64
    # A sampled row crosses with its int32 index and float32 probability.
    assert replay["sampled_bytes_crossed"] * replay["added_items"] == replay["sampled_items"] * (
        replay["ingested_bytes_total"] + 8 * replay["added_items"])
    resilience = stats["resilience"]
    assert resilience["evaluator_errors"] == 0
    if case == "actor_crash":
        assert injected.value(labels={"fault": "actor_crash"}) - before == 1
        assert resilience["actor_crashes"] == 1 and resilience["actor_restarts"] >= 1
    else:
        assert (resilience["actor_crashes"], resilience["actor_restarts"]) == (0, 0)


def test_refusals_with_the_jax_messages():
    with pytest.raises(ValueError, match="system.replay.impl=sharded"):
        ff_dqn.run_experiment(compose(["system.replay.impl=local"]), device="cpu")
    with pytest.raises(ValueError, match="must divide over 3 learner device"):
        ff_dqn.run_experiment(compose(["arch.learner.device_ids=[1,2,3]"]), device="cpu")
    with pytest.raises(NotImplementedError, match="nan_loss"):
        ff_dqn.run_experiment(compose(["arch.fault_spec=nan_loss:2"]), device="cpu")


def test_identity_game_oracle():
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOT,
                             [*chip_smoke.SEBULBA_DQN_IDENTITY, "arch.evaluator_device_id=0"])
    assert ff_dqn.run_experiment(cfg, device="cpu") > chip_smoke.SEBULBA_THRESHOLD
