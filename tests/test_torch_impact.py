"""IMPACT on Sebulba ff_ppo of the PyTorch port (stoix_tpu_torch/ops/losses.py::
impact_loss, systems/ppo/sebulba/ff_ppo.py) against the JAX package's, on
the CPU.

1. `impact_loss` equals `ppo_clip_loss` bitwise where target and behaviour
   coincide (tests/test_impact.py:56), and `jax.jit` of the JAX loss within
   1e-6 relative on random inputs and where `rho_clip` binds.
2. One IMPACT learn step on 1 and 2 shards against the JAX package's own
   `get_impact_learn_step` (jit + shard_map), fed the permutations JAX's
   replicated key draws and a target network apart from the online one:
   losses 1e-5 relative (1e-6 floor), params 1e-5 absolute, one B1 GAE
   call an update; the shards' gradients SUMMED, as the JAX package's
   check_vma=True shard_map sums them (ROADMAP C25), pinned with plain SGD.
3. ImpactIngest's reuse, drop and mixed-payload cases on a scripted
   pipeline (tests/test_impact.py:207-283); the settings' three ValueErrors;
   a custom learn_step_builder refused with IMPACT on.
4. End to end (IdentityGame, 8 envs, two actor threads on device 0): a
   healthy run (staleness from the skip-fetch pipelining, one GAE call an
   update, `LAST_RUN_STATS["impact"]` filled) and one with actor 0 wedged by
   the injected `queue_stall:2` (the learner keeps stepping: reused updates,
   target refreshes, staleness > 0, the fault counted once); `impact` is
   None with IMPACT off.
5. The IdentityGame oracle (SEBULBA_ORACLES["sebulba_impact"]) above 8.0;
   the JAX package returns 10.0 for seeds 42 and 1 (about 12 s on one thread).
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from stoix_tpu.ops import losses as jlosses
from stoix_tpu.systems.ppo.sebulba import ff_ppo as jppo
from stoix_tpu_torch.observability import get_registry
from stoix_tpu_torch.ops import losses
from stoix_tpu_torch.resilience import faultinject
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import make_apply_fn
from stoix_tpu_torch.systems.ppo.sebulba import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
from test_torch_continuous import _count_b1_calls
from test_torch_sebulba_learn import (
    ACTIONS, CPU, E, OBS, T, assert_metrics, assert_params, batch, configs, jax_batch, jax_state,
    port_shards, port_state,
)
from torch_parity import n, paired_networks, t

import chip_smoke


@pytest.fixture(autouse=True)
def clean_faults_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    faultinject.reset()
    yield
    faultinject.reset()
    torch.set_num_threads(threads)


# ----------------------------------------------------------------- the loss


def test_impact_loss_reduces_to_ppo_clip_bitwise():
    rng = np.random.default_rng(0)
    log_prob = t(rng.normal(-1.0, 0.5, 64).astype(np.float32))
    old = t(rng.normal(-1.0, 0.5, 64).astype(np.float32))
    advantage = t(rng.normal(0.0, 1.0, 64).astype(np.float32))
    impact = losses.impact_loss(log_prob, old, old, advantage, epsilon=0.2, rho_clip=2.0)
    assert torch.equal(impact, losses.ppo_clip_loss(log_prob, old, advantage, epsilon=0.2))


@pytest.mark.parametrize("case", ["random", "rho_clip_binds"])
def test_impact_loss_matches_jax(case):
    if case == "random":
        rng = np.random.default_rng(1)
        log_prob, target, behavior = (rng.normal(-1.0, 0.6, 256).astype(np.float32)
                                      for _ in range(3))
        advantage = rng.normal(size=256).astype(np.float32)
    else:  # tests/test_impact.py:71: the first row's rho far past the clip
        log_prob = np.asarray([0.0, -0.5], np.float32)
        target = np.asarray([-0.1, -0.4], np.float32)
        behavior = np.asarray([-5.0, -0.4], np.float32)
        advantage = np.asarray([1.0, -2.0], np.float32)
    want = jax.jit(lambda *a: jlosses.impact_loss(*a, 0.2, 2.0))(
        log_prob, behavior, target, advantage)
    got = losses.impact_loss(t(log_prob), t(behavior), t(target), t(advantage), 0.2, 2.0)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6)


# ----------------------------------------------------------------- the learn step


@pytest.mark.parametrize("shards", [1, 2])
def test_impact_learn_step_matches_jax(shards, devices, monkeypatch):
    cfg, jcfg = configs("ff_ppo", ["system.epochs=2", "system.num_minibatches=2",
                                   "system.actor_lr=1e-3", "system.critic_lr=1e-3",
                                   "system.impact.enabled=true"])
    rho_clip = ff_ppo.impact_settings_from_config(cfg).rho_clip
    ja, jap, jc, jcp, ta, tc = paired_networks(OBS, ACTIONS, (16, 16), seed=3)
    # The target policy: another network's params, so that rho and the ratio
    # to the target both move away from 1.
    _, jtarget_a, _, jtarget_c, _, _ = paired_networks(OBS, ACTIONS, (16, 16), seed=9)
    b = batch(17)
    key = jax.random.PRNGKey(5)
    jstate, jupdates = jax_state(jap, jcp, jcfg, key)
    mesh = Mesh(np.asarray(devices[:shards]), ("data",))
    step = jppo.get_impact_learn_step(ja.apply, jc.apply, jupdates, jcfg, mesh, rho_clip)
    jtarget = jppo.ActorCriticParams(jtarget_a, jtarget_c)
    jnew, jmetrics = step(jstate, jtarget, jax_batch(b))

    permutations, k = [], key
    for _ in range(int(cfg.system.epochs)):
        k, sub = jax.random.split(k)
        permutations.append(torch.from_numpy(np.asarray(
            jax.random.permutation(sub, T * E // shards)).astype(np.int64)))
    state, optims = port_state(ta, tc, cfg)
    target = type(state.params)(
        {name: t(np.asarray(v)) for name, v in _flat(jtarget_a, ta).items()},
        {name: t(np.asarray(v)) for name, v in _flat(jtarget_c, tc).items()})
    learn = ff_ppo.get_impact_learn_step(make_apply_fn(ta), make_apply_fn(tc), optims, cfg,
                                         [CPU] * shards, rho_clip)
    calls = _count_b1_calls(monkeypatch)
    new, metrics = learn(state, target, port_shards(b, shards), permutations=permutations)
    assert calls == {"gae": 1, "generic": 0}
    assert_metrics(metrics, jmetrics, ["actor_loss", "value_loss", "entropy"])
    assert_params(new.params, (jnew.params.actor_params, jnew.params.critic_params))


def test_two_shard_impact_gradients_are_summed_as_jax(devices):
    """ROADMAP C25 on the IMPACT step, with plain SGD on both sides (one
    epoch, one minibatch): the params move by minus the rate times the SUM
    of the two shards' gradients, as JAX's do (Adam would hide the factor)."""
    import optax

    from test_torch_sebulba_dqn import SGD

    cfg, jcfg = configs("ff_ppo", ["system.epochs=1", "system.num_minibatches=1",
                                   "system.impact.enabled=true"])
    ja, jap, jc, jcp, ta, tc = paired_networks(OBS, ACTIONS, (16, 16), seed=3)
    _, jtarget_a, _, jtarget_c, _, _ = paired_networks(OBS, ACTIONS, (16, 16), seed=9)
    b = batch(18)
    key = jax.random.PRNGKey(6)
    jstate, _ = jax_state(jap, jcp, jcfg, key)
    sgd = optax.sgd(0.1)
    jstate = jstate._replace(opt_states=type(jstate.opt_states)(sgd.init(jap), sgd.init(jcp)))
    mesh = Mesh(np.asarray(devices[:2]), ("data",))
    step = jppo.get_impact_learn_step(ja.apply, jc.apply, (sgd.update, sgd.update), jcfg, mesh,
                                      2.0)
    jnew, _ = step(jstate, jppo.ActorCriticParams(jtarget_a, jtarget_c), jax_batch(b))
    _, sub = jax.random.split(key)
    permutation = torch.from_numpy(np.asarray(jax.random.permutation(sub, T * E // 2)).astype(
        np.int64))
    state, _ = port_state(ta, tc, cfg)
    state = state._replace(opt_states=type(state.opt_states)((), ()))
    target = type(state.params)(*({n: t(np.asarray(v)) for n, v in _flat(jp, m).items()}
                                  for jp, m in ((jtarget_a, ta), (jtarget_c, tc))))
    learn = ff_ppo.get_impact_learn_step(make_apply_fn(ta), make_apply_fn(tc),
                                         (SGD(0.1), SGD(0.1)), cfg, [CPU] * 2, 2.0)
    new, _ = learn(state, target, port_shards(b, 2), permutations=[permutation])
    assert_params(new.params, (jnew.params.actor_params, jnew.params.critic_params))
    moved = max(float((state.params.actor_params[k] - new.params.actor_params[k]).abs().max())
                for k in state.params.actor_params)
    assert moved > 1e-3  # far past the 1e-5 bar: a mean would move them half as far


def _flat(flax_params, module):
    """flax params as the port module's {name: tensor}, through a copy of it."""
    import copy

    from stoix_tpu_torch.utils.params import load_flax_params

    twin = copy.deepcopy(module)
    load_flax_params(twin, jax.tree.map(np.asarray, flax_params))
    return {k: v.detach() for k, v in twin.named_parameters()}


# ----------------------------------------------------------------- ingest scheduling


class ScriptedPipe:
    """Scripted (actor_id, (version, payload)) items, one list a poll; a
    wait_for_data with nothing scripted fails the test instead of blocking."""

    def __init__(self, scripted):
        self.scripted = list(scripted)

    def poll(self, max_items=64, timeout=0.0):
        return self.scripted.pop(0) if self.scripted else []

    def wait_for_data(self, timeout=180.0):
        items = self.poll()
        assert items, "learner blocked in wait_for_data with no scripted data"
        return items


def settings(**over):
    base = dict(target_update_interval=1, rho_clip=2.0, max_staleness=3, max_reuse=2,
                buffer_size=2)
    base.update(over)
    return ff_ppo.ImpactSettings(**base)


def assemble(payloads):
    return tuple(payloads)


def test_ingest_reuses_stale_when_fresh_is_late():
    pipe = ScriptedPipe([[(0, (1, "a0")), (1, (1, "b0"))], [], [], [],
                         [(0, (4, "a1")), (1, (4, "b1"))]])
    ingest = ff_ppo.ImpactIngest(pipe, need=2, settings=settings())
    reused = get_registry().counter("stoix_tpu_impact_reused_batches_total")
    before = reused.value()
    first = ingest.next_batch(assemble, current_version=1)
    assert first.fresh and first.behavior_version == 1 and first.batch == ("a0", "b0")
    second = ingest.next_batch(assemble, current_version=2)
    assert not second.fresh and second.batch is first.batch and second.behavior_version == 1
    third = ingest.next_batch(assemble, current_version=3)
    assert not third.fresh and third.batch is first.batch
    fourth = ingest.next_batch(assemble, current_version=4)
    assert fourth.fresh and fourth.behavior_version == 4 and fourth.batch == ("a1", "b1")
    assert reused.value() - before == 2


def test_ingest_drops_overstale_buffered_batches():
    dropped = get_registry().counter("stoix_tpu_impact_dropped_batches_total")
    before = dropped.value()
    pipe = ScriptedPipe([[(0, (1, "old"))], [], [(0, (9, "new"))]])
    ingest = ff_ppo.ImpactIngest(pipe, need=1, settings=settings(max_staleness=2, max_reuse=5))
    assert ingest.next_batch(assemble, current_version=1).fresh
    second = ingest.next_batch(assemble, current_version=10)
    assert second.fresh and second.behavior_version == 9
    assert dropped.value() - before == 1


def test_ingest_mixed_actor_payloads_form_a_full_set():
    pipe = ScriptedPipe([[(1, (2, "b0")), (1, (3, "b1"))]])
    got = ff_ppo.ImpactIngest(pipe, need=2, settings=settings()).next_batch(
        assemble, current_version=3)
    assert got.fresh and got.batch == ("b0", "b1") and got.behavior_version == 2


BASE = ["env=identity_game", "arch.total_num_envs=8", "arch.total_timesteps=2048",
        "arch.num_evaluation=1", "arch.num_eval_episodes=8", "system.rollout_length=8",
        "logger.use_console=False", "arch.actor.device_ids=[0]", "arch.actor.actor_per_device=2",
        "arch.learner.device_ids=[0]", "arch.evaluator_device_id=0",
        "system.num_minibatches=2", "system.multistep_impl=pallas"]


def compose(overrides):
    return config_lib.compose(config_lib.default_config_dir(),
                              "default/sebulba/default_ff_ppo.yaml", [*BASE, *overrides])


@pytest.mark.parametrize("override,match", [
    ("system.impact.rho_clip=0.5", "rho_clip"),
    ("system.impact.target_update_interval=0", "target_update_interval"),
    ("system.impact.max_staleness=0", "max_staleness"),
])
def test_settings_refuse_values_out_of_range(override, match):
    assert ff_ppo.impact_settings_from_config(compose([])) is None
    with pytest.raises(ValueError, match=match):
        ff_ppo.impact_settings_from_config(compose(["system.impact.enabled=true", override]))


def test_custom_learn_step_builder_refused():
    with pytest.raises(ValueError, match="learn_step_builder"):
        ff_ppo.run_experiment(compose(["system.impact.enabled=true"]), device="cpu",
                              learn_step_builder=lambda *a: None)


# ----------------------------------------------------------------- end to end


@pytest.mark.parametrize("case", ["healthy", "queue_stall", "off"])
def test_runs_end_to_end(case, monkeypatch):
    overrides = {"healthy": ["system.impact.enabled=true"],
                 "queue_stall": ["system.impact.enabled=true", "system.update_guard=skip",
                                 "system.impact.target_update_interval=2",
                                 "system.impact.max_staleness=8",
                                 "arch.fault_spec=queue_stall:2"],
                 "off": []}[case]
    injected = get_registry().counter(faultinject.FAULTS_INJECTED)
    before = injected.value(labels={"fault": "queue_stall"})
    calls = _count_b1_calls(monkeypatch)
    ret = ff_ppo.run_experiment(compose(overrides), device="cpu")
    stats = ff_ppo.LAST_RUN_STATS
    updates = 2048 // 64
    assert math.isfinite(ret) and stats["learn_steps"] == updates
    assert calls == {"gae": updates, "generic": 0}  # one GAE call an update, fresh or reused
    impact = stats["impact"]
    if case == "off":
        assert impact is None
        return
    assert impact["updates"] == impact["fresh_updates"] + impact["reused_updates"] == updates
    assert impact["fresh_updates"] >= 1 and impact["target_refreshes"] >= 1
    assert stats["total_env_steps"] == impact["fresh_updates"] * 64
    if case == "queue_stall":
        assert injected.value(labels={"fault": "queue_stall"}) - before == 1
        assert impact["reused_updates"] >= 1
        assert impact["mean_staleness"] > 0 and impact["max_staleness_seen"] >= 1
        assert stats["resilience"]["update_guard"] == "skip"
    else:
        assert impact["mean_staleness"] >= 0
        assert stats["resilience"]["actor_crashes"] == 0


def test_identity_game_oracle():
    _, overrides = chip_smoke.SEBULBA_ORACLES["sebulba_impact"]
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             "default/sebulba/default_ff_ppo.yaml", overrides)
    assert ff_ppo.run_experiment(cfg, device="cpu") > chip_smoke.SEBULBA_THRESHOLD
    assert ff_ppo.LAST_RUN_STATS["impact"]["target_refreshes"] >= 1
