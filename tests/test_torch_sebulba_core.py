"""Sebulba plumbing of the PyTorch port: sebulba/core.py, the supervisor and
parallel/roles.py.

Every queue operation here is bounded (no test can hang): the pipeline's
collect and put take timeouts, the evaluator's waits take timeouts, and the
runs under supervision are joined by their own runner with timeouts.

1. ParameterServer: one placement per device per version, `reprime` reuses
   it (tests/test_sebulba.py:168-200), versions are monotone
   (tests/test_impact.py:99); a version handed to an actor stays bitwise as
   it was after the learner's next update.
2. OnPolicyPipeline: a poison-pill ComponentFailure raises in
   collect_rollouts; a starved collect raises ActorStarvationError naming
   the actor.
3. AsyncEvaluator: drains queued work on stop; `wait_until_idle` raises
   EvaluatorStallError.
4. The supervisor restarts a crashing env's actor, and past its budget the
   learner fails with the ComponentFailure.
5. Roles: every Sebulba case of tests/test_roles.py against the JAX
   package's `resolve_assignments` on the same configs: device ids, axes
   and the findings' text exact.
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from stoix_tpu.parallel import roles as jroles
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch.observability import ActorStarvationError, get_registry
from stoix_tpu_torch.parallel import roles
from stoix_tpu_torch.resilience.errors import ComponentFailure, EvaluatorStallError
from stoix_tpu_torch.sebulba.core import (
    AsyncEvaluator,
    OnPolicyPipeline,
    ParameterServer,
    ThreadLifetime,
    VersionedParams,
)
from stoix_tpu_torch.systems.ppo.sebulba import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
import torch_parity  # noqa: F401  (one intra-op thread, as every port test)

CPU, META = torch.device("cpu"), torch.device("meta")


def _transfers(devices):
    hist = get_registry().histogram("stoix_tpu_sebulba_param_transfer_seconds")
    return sum(int(hist.summary({"queue": "params", "device": str(d)}).get("count", 0))
               for d in devices)


def test_param_server_places_once_per_device_and_reprime_reuses():
    server = ParameterServer([CPU, META], actors_per_device=3)
    before = _transfers([CPU, META])
    server.distribute_params({"w": torch.ones(4)})
    assert _transfers([CPU, META]) - before == 2, "one placement per device, not per actor"
    got = [server.get_params(actor_id, timeout=2.0) for actor_id in range(6)]
    # Actors sharing a device hold the SAME placed copy (identity).
    assert got[0] is got[1] is got[2]
    assert got[3] is got[4] is got[5]
    assert got[0] is not got[3]
    assert got[3]["w"].device == META
    before = _transfers([CPU, META])
    assert server.reprime(2)
    assert _transfers([CPU, META]) == before
    assert server.get_params(2, timeout=2.0) is got[0]


def test_param_server_versions_are_monotone():
    server = ParameterServer([CPU], actors_per_device=2)
    assert server.version == 0
    server.distribute_params({"w": torch.ones(2)})
    assert server.version == 1
    got = server.get_params_versioned(0, timeout=2.0)
    assert isinstance(got, VersionedParams) and got.version == 1
    assert server.get_params(1, timeout=2.0)["w"].shape == (2,)
    server.distribute_params({"w": torch.zeros(2)})
    assert server.version == 2
    assert server.get_params_versioned(0, timeout=2.0).version == 2
    assert server.reprime(1)
    assert server.get_params_versioned(1, timeout=2.0).version == 2
    server.shutdown()
    assert server.get_params_versioned(0, timeout=2.0) is None
    with pytest.raises(queue.Empty):
        server.get_params(0, timeout=0.05)


def test_poison_pill_raises_in_collect():
    pipeline = OnPolicyPipeline(2)
    pipeline.send_rollout(0, "payload", timeout=1.0)
    failure = ComponentFailure("actor-1", "crashed 3 time(s)")
    pipeline.fail(1, failure)
    with pytest.raises(ComponentFailure, match="actor-1 failed unrecoverably"):
        pipeline.collect_rollouts(timeout=5.0)


def test_starved_collect_names_the_actor():
    pipeline = OnPolicyPipeline(2)
    pipeline.send_rollout(0, "payload", timeout=1.0)
    with pytest.raises(ActorStarvationError, match="actor-1") as excinfo:
        pipeline.collect_rollouts(timeout=0.2)
    assert excinfo.value.actor_id == 1
    assert "never produced work" in str(excinfo.value)


def test_async_evaluator_drains_on_stop_and_stall_raises():
    release = threading.Event()
    done = []

    def evaluate(params, generator):
        release.wait(timeout=10.0)
        return {"episode_return": params}

    lifetime = ThreadLifetime()
    evaluator = AsyncEvaluator(evaluate, lifetime, lambda m, p, t: done.append(t))
    evaluator.thread.start()
    for t in range(3):
        evaluator.submit(torch.tensor(float(t)), None, t)
    with pytest.raises(EvaluatorStallError, match="3 request|2 request"):
        evaluator.wait_until_idle(timeout=0.2)
    lifetime.stop()  # requests still queued: the evaluator finishes them first
    release.set()
    evaluator.wait_until_idle(timeout=10.0)
    evaluator.thread.join(timeout=10.0)
    assert not evaluator.thread.is_alive()
    assert done == [0, 1, 2]


# ---------------------------------------------------------------- runs

BASE = ["env=identity_game", "arch.total_num_envs=8", "arch.total_timesteps=512",
        "arch.num_evaluation=1", "arch.num_eval_episodes=8", "system.rollout_length=8",
        "logger.use_console=False", "arch.actor.device_ids=[0]",
        "arch.learner.device_ids=[0]", "arch.supervision.backoff_base_s=0.01"]


def _compose(overrides):
    return config_lib.compose(config_lib.default_config_dir(),
                              "default/sebulba/default_ff_ppo.yaml", BASE + overrides)


def _crashing_factory(monkeypatch, crashes: int):
    """make_factory whose first `crashes` env batches raise at their third step."""
    made = []
    real = ff_ppo.make_factory

    def make_factory(config):
        factory = real(config)

        def build(num_envs):
            envs = factory(num_envs)
            made.append(envs)
            if len(made) > 1 and len(made) <= crashes + 1:  # the probe env is the first
                steps = [0]
                step = envs.step

                def crashing_step(action):
                    steps[0] += 1
                    if steps[0] == 3:
                        raise RuntimeError("env backend died")
                    return step(action)

                envs.step = crashing_step
            return envs

        return build

    monkeypatch.setattr(ff_ppo, "make_factory", make_factory)
    return made


def test_supervisor_restarts_a_crashed_actor(monkeypatch):
    _crashing_factory(monkeypatch, crashes=1)
    ret = ff_ppo.run_experiment(_compose(["arch.actor.actor_per_device=1"]), device="cpu")
    stats = ff_ppo.LAST_RUN_STATS
    assert np.isfinite(ret)
    assert stats["learn_steps"] == 8
    assert stats["resilience"]["actor_crashes"] == 1
    assert stats["resilience"]["actor_restarts"] == 1
    assert stats["resilience"]["supervisor_restarts"] == 1


def test_supervisor_past_its_budget_fails_the_learner(monkeypatch):
    _crashing_factory(monkeypatch, crashes=10)
    start = time.monotonic()
    with pytest.raises(ComponentFailure, match="max_restarts=2 exhausted"):
        ff_ppo.run_experiment(_compose(["arch.actor.actor_per_device=1"]), device="cpu")
    assert time.monotonic() - start < 60.0


def test_actor_tree_is_unchanged_by_the_next_update():
    """The version an actor holds stays bitwise as it was after the
    learner's next update (nothing writes a parameter in place), with the
    guard and the statistics on."""
    from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import make_apply_fn, make_optimizers
    from stoix_tpu_torch.systems.anakin import make_generator
    from stoix_tpu_torch.ops import running_statistics
    from stoix_tpu_torch.utils.tree import tree_leaves, tree_map
    from test_torch_sebulba_learn import ACTIONS, OBS, batch, port_shards
    from torch_parity import paired_networks

    cfg = _compose(["system.normalize_observations=true", "system.update_guard=skip",
                    "arch.num_updates=4", "system.epochs=2", "system.num_minibatches=2"])
    *_, actor, critic = paired_networks(OBS, ACTIONS, (16, 16), seed=1)
    optims = make_optimizers(cfg)
    params = ff_ppo.ActorCriticParams(
        {k: v.detach() for k, v in actor.named_parameters()},
        {k: v.detach() for k, v in critic.named_parameters()})
    state = ff_ppo.CoreLearnerState(
        params, ff_ppo.ActorCriticOptStates(optims[0].init(params.actor_params),
                                            optims[1].init(params.critic_params)),
        make_generator(0, CPU), running_statistics.init_state(torch.zeros(OBS)))
    learn = ff_ppo.get_learn_step(make_apply_fn(actor), make_apply_fn(critic), optims, cfg,
                                  [CPU])
    server = ParameterServer([CPU], actors_per_device=1)
    server.distribute_params((state.params, state.obs_stats))
    held = server.get_params(0, timeout=2.0)
    snapshot = tree_map(lambda x: x.clone(), held)
    for seed in range(2):
        state, _ = learn(state, port_shards(batch(seed), 1))
        server.distribute_params((state.params, state.obs_stats))
    for a, b in zip(tree_leaves(held), tree_leaves(snapshot)):
        assert torch.equal(a, b)
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(state.params),
                                                    tree_leaves(snapshot[0]))]
    assert all(moved)


# ---------------------------------------------------------------- roles

ROLE_CASES = {
    "split": {"arch": {"architecture_name": "sebulba", "actor": {"device_ids": [0, 2]},
                       "learner": {"device_ids": [1, 3]}, "evaluator_device_id": 2}},
    "colocated": {"arch": {"architecture_name": "sebulba", "actor": {"device_ids": [0]},
                           "learner": {"device_ids": [0]}, "evaluator_device_id": 0}},
    "partial_overlap": {"arch": {"architecture_name": "sebulba",
                                 "actor": {"device_ids": [0, 1]},
                                 "learner": {"device_ids": [1, 2]}, "evaluator_device_id": 0}},
    "out_of_range": {"arch": {"architecture_name": "sebulba", "actor": {"device_ids": [0]},
                              "learner": {"device_ids": [9]}, "evaluator_device_id": 12}},
    "empty_primary": {"arch": {"architecture_name": "sebulba", "actor": {"device_ids": []},
                               "learner": {"device_ids": [1]}}},
    "explicit_without_learn": {"arch": {"roles": {"act": {"device_ids": [0]}}}},
    "identical_sets": {"arch": {"roles": {"act": {"device_ids": [0, 1]},
                                          "learn": {"device_ids": [1, 0]}}}},
    "all_act_subset_learn": {"arch": {"roles": {"act": {}, "learn": {"device_ids": [1]}}}},
    "explicit_full_range": {"arch": {"roles": {"act": {},
                                               "learn": {"device_ids": [0, 1, 2, 3]}}}},
    "unknown_role": {"arch": {"roles": {"learn": {"device_ids": [0]}, "judge": {}}}},
    "two_free_axes": {"arch": {"roles": {"learn": {"device_ids": [0],
                                                   "mesh": {"data": -1, "model": -1}}}}},
}


def _resolved(module, config, count):
    try:
        return {role: (a.device_ids, a.axes)
                for role, a in module.resolve_assignments(config, device_count=count).items()}
    except (roles.MeshRolesError, jroles.MeshRolesError) as error:
        return ("findings", error.findings)


@pytest.mark.parametrize("count", [None, 1, 2, 4])
@pytest.mark.parametrize("case", list(ROLE_CASES))
def test_resolve_assignments_matches_jax(case, count):
    config = ROLE_CASES[case]
    assert _resolved(roles, config, count) == _resolved(jroles, config, count)


@pytest.mark.parametrize("overrides", [
    [],  # the default arch: actors on 0, the learner on 1
    ["arch.actor.device_ids=[0]", "arch.learner.device_ids=[0]"],
    ["arch.actor.device_ids=[0,2]", "arch.learner.device_ids=[1,3]",
     "arch.evaluator_device_id=2"],
])
@pytest.mark.parametrize("count", [1, 4])
def test_sebulba_configs_resolve_as_in_jax(overrides, count):
    """The composed Sebulba configs, on a host of one card and of four: the
    same devices, or the same findings (the default learner on device 1 is
    refused on one card)."""
    root = "default/sebulba/default_ff_ppo.yaml"
    cfg = config_lib.compose(config_lib.default_config_dir(), root, overrides)
    jcfg = jax_config.compose(jax_config.default_config_dir(), root, overrides)
    assert _resolved(roles, cfg, count) == _resolved(jroles, jcfg, count)
    devices = [torch.device("cuda", i) for i in range(count)]
    try:
        mesh_roles = roles.MeshRoles.from_config(cfg, devices=devices)
    except roles.MeshRolesError as error:
        assert _resolved(jroles, jcfg, count) == ("findings", error.findings)
        return
    ids = jroles.resolve_assignments(jcfg, device_count=count)
    assert mesh_roles.role_devices("act") == [devices[i] for i in ids["act"].device_ids]
    assert mesh_roles.learn_mesh() == [devices[i] for i in ids["learn"].device_ids]
    assert mesh_roles.device("evaluate") == devices[ids["evaluate"].device_ids[0]]
    assert mesh_roles.colocated("act", "learn") == (
        set(ids["act"].device_ids) == set(ids["learn"].device_ids))
