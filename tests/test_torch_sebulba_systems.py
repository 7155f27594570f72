"""The four Sebulba systems of the PyTorch port end to end on the CPU, and
their refusals.

1. Sebulba ff_ppo, ff_impala, ff_impala_shared_torso and ff_dqn through
   their `run_experiment` at tests/test_sebulba.py's BASE (IdentityGame, 8
   envs, 2048 steps, two actor threads), every role on device 0 (a one-card
   host's shape): finite, exactly `num_updates` learn steps, one B1 call an
   update (GAE) on ff_ppo, `num_minibatches` (V-trace) on the IMPALAs and
   none on ff_dqn, no actor crash, restart or evaluator error. Also ff_ppo
   on the native pool (CartPole) and on Pendulum (continuous, a negative
   return), and with two learner "devices".
2. The entry points default to CUDA and never fall back to the CPU.
3. `env.backend` gymnasium and envpool build the port's adapters: ff_ppo
   trains on gymnasium CartPole-v1 (evaluated on its registry twin); the
   envpool factory raises its missing-package error without `envpool`.
   Every refusal raises NotImplementedError naming its key: the fleet,
   integrity and preflight layers, a fault
   the Sebulba runners do not inject (`arch.fault_spec=bitflip:1`,
   `sigterm:1`; they take `actor_crash` and `queue_stall`), and ROADMAP
   C24's unread knobs (`system.replay.impl: sharded`, which the JAX
   Sebulba PPO never reads, `system.fused_update`, `system.clip_value` on
   ff_ppo, `system.update_guard` on the shared torso); IMPACT's settings
   out of range raise the JAX package's ValueErrors; the default arch's
   learner on device 1 is refused on a one-card host with the JAX
   package's findings.
"""

import importlib.util
import math

import pytest
import torch

from stoix_tpu_torch.parallel.roles import MeshRolesError
from stoix_tpu_torch.systems.impala.sebulba import ff_impala, ff_impala_shared_torso
from stoix_tpu_torch.systems.ppo.sebulba import ff_ppo
from stoix_tpu_torch.systems.q_learning.sebulba import ff_dqn
from stoix_tpu_torch.utils import config as config_lib
from test_torch_continuous import _count_b1_calls

BASE = ["env=identity_game", "arch.total_num_envs=8", "arch.total_timesteps=2048",
        "arch.num_evaluation=1", "arch.num_eval_episodes=8", "system.rollout_length=8",
        "logger.use_console=False", "arch.actor.device_ids=[0]",
        "arch.learner.device_ids=[0]", "system.multistep_impl=pallas"]
SYSTEMS = {"ff_ppo": ff_ppo, "ff_impala": ff_impala,
           "ff_impala_shared_torso": ff_impala_shared_torso, "ff_dqn": ff_dqn}
# B1 calls an update: (GAE, generic).
B1_CALLS = {"ff_ppo": (1, 0), "ff_impala": (0, 4), "ff_impala_shared_torso": (0, 4),
            "ff_dqn": (0, 0)}


def compose(system, overrides):
    return config_lib.compose(config_lib.default_config_dir(),
                              f"default/sebulba/default_{system}.yaml", overrides)


def _stats(system):
    """The run stats of `system` (the on-policy systems share ff_ppo's runner)."""
    return (ff_dqn if system == "ff_dqn" else ff_ppo).LAST_RUN_STATS


def _assert_clean_run(ret, updates, system="ff_ppo"):
    stats = _stats(system)
    assert math.isfinite(ret)
    assert stats["learn_steps"] == updates
    resilience = stats["resilience"]
    assert (resilience["actor_crashes"], resilience["actor_restarts"],
            resilience["evaluator_errors"]) == (0, 0, 0)
    assert stats["fps"] > 0


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_each_system_runs_end_to_end(system, monkeypatch):
    cfg = compose(system, BASE)
    calls = _count_b1_calls(monkeypatch)
    ret = SYSTEMS[system].run_experiment(cfg, device="cpu")
    updates = 2048 // (8 * 8)
    _assert_clean_run(ret, updates, system)
    gae, generic = B1_CALLS[system]
    assert calls == {"gae": gae * updates, "generic": generic * updates}
    assert _stats(system)["num_actors"] == 2
    assert _stats(system)["envs_per_actor"] == 4


@pytest.mark.parametrize("overrides", [
    ["env=cartpole", "env.backend=cvec"],
    ["arch.learner.device_ids=[1,2]", "arch.evaluator_device_id=3",
     "system.num_minibatches=2"],
])
def test_ppo_on_the_pool_and_over_two_learner_devices(overrides):
    cfg = compose("ff_ppo", [*BASE, "arch.total_timesteps=512", *overrides])
    _assert_clean_run(ff_ppo.run_experiment(cfg, device="cpu"), 8)


def test_ppo_continuous_on_the_native_pool():
    """tests/test_sebulba.py:100-127: Pendulum through the pool's continuous
    entry, the tanh-Gaussian head inferred from its Box."""
    cfg = compose("ff_ppo", ["env=pendulum", "env.backend=cvec", "env.kwargs.max_steps=200",
                             "network=mlp_continuous", "arch.total_num_envs=8",
                             "arch.total_timesteps=2048", "arch.num_evaluation=1",
                             "arch.num_eval_episodes=4", "system.rollout_length=8",
                             "system.num_minibatches=2", "logger.use_console=False",
                             "arch.actor.device_ids=[0]", "arch.actor.actor_per_device=1",
                             "arch.learner.device_ids=[0]"])
    ret = ff_ppo.run_experiment(cfg, device="cpu")
    _assert_clean_run(ret, 32)
    assert ret < 0.0


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_entry_point_defaults_to_cuda_and_never_falls_back(system, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        SYSTEMS[system].run_experiment(compose(system, BASE))


REFUSALS = [
    # Integrity, preflight, telemetry, the fleet and the HTTP ops plane run on
    # the PPO/IMPALA runner (test_sebulba_integrity_checks_at_eval_boundaries,
    # test_the_fleet_and_http_layers_run_on_sebulba); the compile cache stays
    # refused, and Sebulba ff_dqn refuses the layers its JAX runner never
    # reads, the fleet among them (ROADMAP C24).
    ("ff_ppo", "arch.compile_cache.enabled=true", "arch.compile_cache.enabled"),
    ("ff_dqn", "arch.fleet.enabled=true", "arch.fleet.enabled"),
    # Faults of layers not ported: the Sebulba runners inject actor_crash
    # and queue_stall only.
    ("ff_ppo", "arch.fault_spec=bitflip:1", "bitflip"),
    ("ff_dqn", "arch.fault_spec=sigterm:1", "sigterm"),
    ("ff_dqn", "arch.integrity.enabled=true", "arch.integrity.enabled"),
    # One copy of the learner state: the determinism probe is the check.
    ("ff_impala", "arch.integrity.enabled=true", "arch.integrity.determinism_probe_interval"),
    # ROADMAP C24: knobs the JAX Sebulba learners never read.
    ("ff_ppo", "system.replay.impl=sharded", "system.replay.impl=sharded"),
    ("ff_ppo", "system.fused_update=true", "system.fused_update"),
    ("ff_ppo", "system.clip_value=false", "system.clip_value"),
    ("ff_impala_shared_torso", "system.update_guard=skip", "system.update_guard"),
]


@pytest.mark.parametrize("system,backend", [("ff_ppo", "gymnasium"), ("ff_impala", "envpool")])
def test_backends_build_their_adapters_for_the_systems(system, backend, monkeypatch):
    """`env.backend` gymnasium and envpool, refused before A15b, reach the
    port's adapters: ff_ppo trains a window on gymnasium CartPole-v1 (the
    registry's CartPole-v1 is its twin, which evaluates it, by the JAX
    package's rule), and
    ff_impala's envpool factory raises the JAX package's missing-package
    error where `envpool` is not installed."""
    overrides = [*(o for o in BASE if not o.startswith("env=")), "env=cartpole",
                 f"env.backend={backend}", "env.scenario.name=CartPole-v1"]
    if backend == "gymnasium":
        pytest.importorskip("gymnasium")
        cfg = compose(system, [*overrides, "arch.total_timesteps=1024", "arch.num_eval_episodes=2",
                               "arch.eval_max_steps=600"])
        ret = SYSTEMS[system].run_experiment(cfg, device="cpu")
        _assert_clean_run(ret, 1024 // (8 * 8), system)
        assert ret > 0.0
    else:
        if importlib.util.find_spec("envpool") is not None:
            pytest.skip("envpool is installed: the missing-package error cannot show")
        with pytest.raises(ImportError, match="requires the optional 'envpool' package"):
            SYSTEMS[system].run_experiment(compose(system, overrides), device="cpu")


@pytest.mark.parametrize("system,override,key", REFUSALS)
def test_refusals_raise_naming_the_key(system, override, key):
    cfg = compose(system, [*BASE, override])
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        SYSTEMS[system].run_experiment(cfg, device="cpu")


@pytest.mark.parametrize("system,override", [
    ("ff_impala", "arch.fleet.enabled=true"),
    ("ff_impala_shared_torso", "logger.telemetry.http.enabled=true")])
def test_the_fleet_and_http_layers_run_on_sebulba(system, override):
    from stoix_tpu_torch import observability

    cfg = compose(system, [*BASE, override])
    try:
        ret = SYSTEMS[system].run_experiment(cfg, device="cpu")
        _assert_clean_run(ret, 2048 // (8 * 8), system)
        stats = _stats(system)
        assert stats["resilience"]["fleet"] is ("fleet" in override)
        # One process: each window's verdict is its own flags.
        assert stats["fleet_decisions"] == (["fleet healthy"] if "fleet" in override else None)
        assert (observability.get_ops_server() is not None) is ("http" in override)
    finally:
        observability.shutdown()


@pytest.mark.parametrize("override,match", [
    ("system.impact.rho_clip=0.5", "rho_clip"),
    ("system.impact.target_update_interval=0", "target_update_interval"),
    ("system.impact.max_reuse=-1", "max_reuse"),
])
def test_impact_settings_out_of_range_are_refused(override, match):
    cfg = compose("ff_ppo", [*BASE, "system.impact.enabled=true", override])
    with pytest.raises(ValueError, match=match):
        ff_ppo.run_experiment(cfg, device="cpu")


def test_default_learner_device_is_refused_on_one_card(monkeypatch):
    """The default arch puts the learner on device 1: a one-card host
    refuses it with every finding, as the JAX package's roles do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(MeshRolesError, match=r"device ids \[1\] out of range for the 1 probed"):
        ff_ppo.run_experiment(compose("ff_ppo", ["env=identity_game"]))
