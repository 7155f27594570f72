"""The population's shrink and grow in the PyTorch port
(stoix_tpu_torch/population/elastic.py) against the JAX package's
(stoix_tpu/population/elastic.py, tests/test_elastic.py).

The selection, clone sources, shrink, the grow fed JAX's coins (the clones'
hparams at exactly float32(0.8 or 1.2) times their source's), the size plan
and the relaunch overrides (equal strings) go through both packages; then a
fleet emergency store saved by a population of 8 is restored at 4 and at 12
through `restore_emergency(..., raw_transform=...)` and through the runner.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from stoix_tpu.population import elastic as jax_elastic
from stoix_tpu.resilience.elastic import ElasticResizeError as JaxResizeError
from stoix_tpu_torch.population import elastic
from stoix_tpu_torch.population import runner as prun
from stoix_tpu_torch.resilience import fleet
from stoix_tpu_torch.resilience.elastic import ElasticResizeError
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.checkpointing import flatten_state

FITNESSES = [
    [3.0, np.nan, 7.0, 1.0, 9.0, 2.0, 5.0, -np.inf],
    [1.0, 9.0, 5.0, 7.0],
    [2.0, 2.0, 2.0, np.inf, -np.inf, 2.0],
    [np.nan, np.nan, 0.5],
]


@pytest.mark.parametrize("fitness", FITNESSES)
def test_survivors_and_clone_sources_equal_the_jax_package(fitness):
    old = len(fitness)
    for new in range(1, old + 1):
        assert (elastic.select_survivors(fitness, new).tolist()
                == jax_elastic.select_survivors(fitness, new).tolist())
    for new in range(old, 3 * old + 1):
        assert (elastic.clone_sources(fitness, old, new).tolist()
                == jax_elastic.clone_sources(fitness, old, new).tolist())


def store_8() -> dict:
    """tests/test_elastic.py's hand-built 8-member store."""
    rng = np.random.default_rng(0)
    return {
        "members/w": rng.standard_normal((8, 3)).astype(np.float32),
        "hparams/actor_lr": (np.arange(8, dtype=np.float32) + 1.0) * 1e-3,
        "fitness": np.array([3.0, np.nan, 7.0, 1.0, 9.0, 2.0, 5.0, -np.inf], np.float32),
        "updates_done": np.asarray(12, np.int64),
        "params/actor": rng.standard_normal((4,)).astype(np.float32),
    }


def stores_4():
    """tests/test_elastic.py's 4-member store for the JAX package, and the
    port's: its member streams and PBT stream are generator states."""
    rng = np.random.default_rng(1)
    member_keys = np.stack(
        [np.asarray(jax.random.split(jax.random.PRNGKey(i), 6)) for i in range(4)]
    ).reshape(4, 2, 3, 2)
    shared = {
        "members/w": rng.standard_normal((4, 3)).astype(np.float32),
        "hparams/actor_lr": np.array([1e-3, 2e-3, 3e-3, 4e-3], np.float32),
        "hparams/ent_coef": np.array([0.01, 0.02, 0.03, 0.04], np.float32),
        "hparams/seed": np.array([10, 11, 12, 13], np.int32),
        "fitness": np.array([1.0, 9.0, 5.0, 7.0], np.float32),
        "updates_done": np.asarray(3, np.int64),
    }
    jax_store = {**shared, "members/key": member_keys.astype(np.uint32),
                 "pbt_key": np.asarray(jax.random.PRNGKey(42)).astype(np.uint32)}
    port_store = {**shared,
                  "members/generator": rng.integers(0, 256, (4, 16)).astype(np.uint8),
                  "members/env_state/generator": np.stack([
                      torch.Generator().manual_seed(i).get_state().numpy() for i in range(4)]),
                  "pbt_generator": torch.Generator().manual_seed(42).get_state().numpy()}
    return jax_store, port_store


def jax_grow_coins(store, new_size):
    """The coins JAX's grow draws (its elastic.py:193-214)."""
    explore = jax.random.fold_in(jax.numpy.asarray(store["pbt_key"]), 0x9E37)
    names = sorted(k.split("/", 1)[1] for k in store if k.startswith("hparams/"))
    return {name: np.asarray(jax.random.bernoulli(jax.random.fold_in(explore, i), 0.5,
                                                  (new_size,)))
            for i, name in enumerate(names)}


def test_shrink_equals_the_jax_package_bitwise():
    want = jax_elastic.resize_arrays(store_8(), 4)
    raw = store_8()
    got = elastic.resize_arrays(dict(raw), 4)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.asarray(got[key]).tobytes() == np.asarray(want[key]).tobytes(), key
    assert got["updates_done"] is raw["updates_done"] and got["params/actor"] is raw["params/actor"]


@pytest.mark.parametrize("new_size", [5, 8, 11])
def test_grow_fed_jax_coins_equals_the_jax_package(new_size):
    jax_store, port_store = stores_4()
    want = jax_elastic.resize_arrays(dict(jax_store), new_size, perturb_scale=0.2)
    got = elastic.resize_arrays(dict(port_store), new_size, perturb_scale=0.2,
                                coins=jax_grow_coins(jax_store, new_size))
    for key in ("members/w", "hparams/actor_lr", "hparams/ent_coef", "hparams/seed", "fitness",
                "updates_done"):
        assert np.asarray(got[key]).tobytes() == np.asarray(want[key]).tobytes(), key
    src = elastic.clone_sources(port_store["fitness"], 4, new_size)
    for slot in range(4, new_size):
        for name in ("actor_lr", "ent_coef"):
            source = port_store[f"hparams/{name}"][src[slot]]
            assert got[f"hparams/{name}"][slot] in (source * np.float32(0.8),
                                                     source * np.float32(1.2))
    # The member streams: old members' kept, every clone's fresh and its own;
    # the env streams follow their source; the PBT stream advanced.
    streams = got["members/generator"]
    assert streams[:4].tobytes() == port_store["members/generator"].tobytes()
    fresh = {streams[slot].tobytes() for slot in range(4, new_size)}
    assert len(fresh) == new_size - 4
    assert not fresh & {row.tobytes() for row in port_store["members/generator"]}
    env_streams = got["members/env_state/generator"]
    assert env_streams.tobytes() == port_store["members/env_state/generator"][src].tobytes()
    assert got["pbt_generator"].tobytes() != port_store["pbt_generator"].tobytes()
    again = elastic.resize_arrays(dict(port_store), new_size,
                                  coins=jax_grow_coins(jax_store, new_size))
    assert all(np.asarray(again[k]).tobytes() == np.asarray(got[k]).tobytes() for k in got)


def test_identity_off_population_stores_and_at_the_same_size():
    plain = {"params/actor": np.ones((3,), np.float32)}
    assert elastic.resize_arrays(plain, 4) is plain
    sized = store_8()
    assert elastic.resize_arrays(sized, 8) is sized
    transform = elastic.raw_resize_transform({"arch": {"population": {"size": 4,
                                                                      "max_size": 8}}})
    assert transform(dict(store_8()))["fitness"].shape == (4,)
    _, port_store = stores_4()
    assert transform(port_store) is port_store


def _error(package, fn, *args, **kwargs):
    errors = (ElasticResizeError, JaxResizeError, ValueError)
    with pytest.raises(errors) as got:
        fn(*args, **kwargs)
    return type(got.value).__name__, str(got.value)


@pytest.mark.parametrize("case", ["below_one", "past_max", "not_a_shrink", "no_devices",
                                  "bad_max_size"])
def test_refusals_are_typed_with_the_jax_packages_messages(case):
    _, port_store = stores_4()
    jax_store, _ = stores_4()
    calls = {
        "below_one": lambda m: m.validate_resize(4, 0),
        "past_max": lambda m: m.resize_arrays(dict(jax_store if m is jax_elastic else port_store),
                                              8, max_size=6),
        "not_a_shrink": lambda m: m.select_survivors([1.0, 2.0], 3),
        "no_devices": lambda m: m.plan_population_size({"arch": {"population": {"size": 4}}},
                                                        4, 0),
        "bad_max_size": lambda m: m.max_population_size(
            {"arch": {"population": {"size": 4, "max_size": 0}}}),
    }
    assert _error(elastic, calls[case], elastic) == _error(jax_elastic, calls[case], jax_elastic)


PLAN_CASES = [
    ({"size": 8, "max_size": 6}, 4, 8), ({"size": 8, "max_size": 6}, 16, 8),
    ({"size": 2}, 1, 8), ({"size": 3}, 3, 2), ({"size": 5, "max_size": 5}, 2, 1),
]


@pytest.mark.parametrize("population,target,source", PLAN_CASES)
def test_size_plan_and_overrides_equal_the_jax_package(population, target, source):
    config = {"arch": {"population": {**population, "hparams": {
        "system.actor_lr": [1e-3 * (i + 1) for i in range(population["size"])],
        "system.gamma": 0.99, "arch.seed": list(range(population["size"]))}}}}
    assert (elastic.plan_population_size(config, target, source)
            == jax_elastic.plan_population_size(config, target, source))
    for stats in ({}, {"member_fitness": [float(v) for v in np.linspace(
            1.0, -1.0, population["size"])]}, {"member_fitness": [1.0]}):
        assert (elastic.population_resize_overrides(config, target_devices=target,
                                                    from_devices=source, stats=stats)
                == jax_elastic.population_resize_overrides(config, target_devices=target,
                                                           from_devices=source, stats=stats))


# ------------------------------------------------------------ a real population store


OVERRIDES = ["env=identity_game", "arch.total_num_envs=8", "arch.total_timesteps=~",
             "arch.num_updates=1", "arch.num_evaluation=1", "arch.num_eval_episodes=4",
             "arch.absolute_metric=False", "system.rollout_length=4", "system.epochs=1",
             "system.num_minibatches=2", "logger.use_console=False"]
FITNESS_8 = [3.0, float("nan"), 7.0, 1.0, 9.0, 2.0, 5.0, -float("inf")]


def population_config(size, extra=()):
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             "default/population/default_ff_ppo.yaml", OVERRIDES + list(extra))
    config_lib._set_dotted(cfg, "arch.population.size", size)
    config_lib._set_dotted(cfg, "arch.population.hparams", {
        "system.ent_coef": 0.01, "system.actor_lr": 3.0e-4})
    return cfg


def population_state(size):
    from stoix_tpu_torch import envs

    cfg = population_config(size)
    from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps

    cfg = check_total_timesteps(cfg, 1)
    env, _ = envs.make(cfg)
    setup = prun.population_setup(env, cfg, torch.device("cpu"), 5)
    state = setup.learn(setup.learner_state).learner_state
    return state._replace(fitness=torch.tensor((FITNESS_8 * 2)[:size], dtype=torch.float32)), setup


def flat(tree):
    out = {}
    for path, leaf in flatten_state(tree):
        if leaf is None:
            continue
        if isinstance(leaf, torch.Generator):
            leaf = leaf.get_state()
        out["/".join(path)] = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def store_of_8(tmp_path_factory):
    root = tmp_path_factory.mktemp("population_store")
    state, _ = population_state(8)
    settings = fleet.FleetSettings(enabled=True, heartbeat_interval_s=0.05,
                                   heartbeat_timeout_s=0.5, monitor_poll_s=0.05,
                                   barrier_deadline_s=1.0, skew_warn_ratio=2.0,
                                   exit_grace_s=0.0, emergency_dir=str(root))
    coord = fleet.FleetCoordinator(settings, backend=None, process_index=0, process_count=1,
                                   interrupt_on_partition=False)
    coord.stage_candidate(64, state)
    coord.confirm_candidate(64)
    return coord.emergency_save(), flat(state)


def test_emergency_store_of_8_restores_at_4_and_12_through_the_transform(store_of_8):
    path, saved = store_of_8
    with open(os.path.join(path, fleet.MANIFEST_NAME)) as f:
        digests = json.load(f)["digests"]
    keep = elastic.select_survivors(FITNESS_8, 4)
    for size in (4, 12):
        template, _ = population_state(size)
        restored, step = fleet.restore_emergency(
            template, path, raw_transform=elastic.raw_resize_transform(population_config(size)))
        report = fleet.read_restore_report(path)
        assert step == 64 and report["transformed"] is True and not report["reinitialized"]
        got = flat(restored)
        assert sorted(got) == sorted(saved)
        for key, value in saved.items():
            if not elastic.is_population_leaf(key):
                if key == "pbt_generator" and size == 12:
                    continue  # a grow consumes the PBT stream (below)
                # Kept whole: its placed digest is the store's.
                assert report["digests"][key] == digests[key], key
                assert got[key].tobytes() == value.tobytes(), key
            elif size == 4:
                assert got[key].tobytes() == value[keep].tobytes(), key
            else:
                assert got[key][:8].tobytes() == value.tobytes(), key
        if size == 12:
            src = elastic.clone_sources(FITNESS_8, 8, 12)
            weight = "members/params/actor_params/torso.dense.0.weight"
            for slot in range(8, 12):
                assert got[weight][slot].tobytes() == saved[weight][src[slot]].tobytes()
                for name in ("ent_coef", "actor_lr"):
                    source = saved[f"hparams/{name}"][src[slot]]
                    assert got[f"hparams/{name}"][slot] in (source * np.float32(0.8),
                                                             source * np.float32(1.2))
                assert got["members/generator"][slot].tobytes() != \
                    saved["members/generator"][src[slot]].tobytes()
            assert got["pbt_generator"].tobytes() != saved["pbt_generator"].tobytes()
        else:
            assert got["pbt_generator"].tobytes() == saved["pbt_generator"].tobytes()


def test_the_runner_restores_a_store_of_8_at_4(store_of_8, tmp_path, monkeypatch):
    path, saved = store_of_8
    monkeypatch.chdir(tmp_path)
    cfg = population_config(4, ["logger.checkpointing.load_model=true",
                                f"logger.checkpointing.load_args.load_path={path}"])
    assert np.isfinite(prun.run_population_experiment(cfg, device="cpu"))
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == 64
    stats = prun.LAST_POPULATION_STATS
    assert stats["population_size"] == 4 and len(stats["member_fitness"]) == 4
    assert stats["windows"] == int(saved["updates_done"]) + 1
    assert fleet.read_restore_report(path)["transformed"] is True


def test_resize_population_state_is_the_raw_transform_in_process():
    state, _ = population_state(4)
    before = flat(state)
    for size in (2, 6):
        resized = flat(elastic.resize_population_state(state, size))
        raw = elastic.resize_arrays(dict(before), size)
        assert sorted(resized) == sorted(raw)
        for key, value in raw.items():
            assert resized[key].tobytes() == np.asarray(value).tobytes(), key
