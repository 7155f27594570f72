"""The topology-elastic half of the PyTorch port against the JAX package's,
on the same inputs: `roles.elastic_mesh_axes` (refusals included), the
resize protocol of resilience/elastic.py (`plan_resize`,
`topology_overrides`, `survivor_overrides`, the request's round trip and
one-shot consume), and `utils/checkpointing.place_host_leaves` (matched
count, reinitialized keys, the errors). Then the port's own elastic runs
over two gloo ranks (tests/torch_fleet_worker.py): a checkpoint saved by one
process restores in two and one saved by two restores in one, the
replicated leaves bit for bit and the per-rank fields reported as
reinitialized; and `shrink:0` exits 89 with a resize request naming one
device and the JAX package's overrides for that config.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from stoix_tpu.parallel import roles as jax_roles
from stoix_tpu.resilience import elastic as jax_elastic
from stoix_tpu.resilience.errors import CheckpointIntegrityError as JaxIntegrityError
from stoix_tpu.utils import checkpointing as jax_checkpointing
from stoix_tpu_torch.observability import flightrec
from stoix_tpu_torch.parallel import roles
from stoix_tpu_torch.resilience import elastic, faultinject, fleet
from stoix_tpu_torch.resilience.errors import CheckpointIntegrityError
from stoix_tpu_torch.resilience.exit_codes import EXIT_CODE_ELASTIC_RESIZE
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import checkpointing
from stoix_tpu_torch.utils import config as config_lib
import torch_fleet_worker as worker
import torch_parity  # noqa: F401  (one torch thread)

REPLICATED = ("params", "opt_states", "obs_stats", "kl_beta")
PER_RANK = ("generator", "env_state", "timestep")


@pytest.fixture(autouse=True)
def _no_fault_leakage():
    yield
    faultinject.reset()


# ------------------------------------------------------------ mesh and resize protocol


@pytest.mark.parametrize("axes,count", [
    ({"data": -1}, 3), (None, 1), ({"pop": 2, "data": 4}, 4), ({"pop": 2, "data": 4}, 16),
    ({"data": 8}, 2), ({"pop": 3, "data": 2}, 4), ({"model": 2}, 4), ({"data": 2}, 0)])
def test_elastic_mesh_axes_equals_the_jax_package(axes, count):
    try:
        want = jax_roles.elastic_mesh_axes(axes, count)
    except jax_roles.MeshRolesError as error:
        with pytest.raises(roles.MeshRolesError) as got:
            roles.elastic_mesh_axes(axes, count)
        assert str(got.value) == str(error)
        return
    assert roles.elastic_mesh_axes(axes, count) == want


@pytest.mark.parametrize("action,count", [("shrink", 8), ("shrink", 2), ("grow", 1),
                                          ("shrink", 1), ("grow", 0), ("twist", 4)])
def test_plan_resize_equals_the_jax_package(action, count):
    try:
        want = jax_elastic.plan_resize(action, count)
    except jax_elastic.ElasticResizeError as error:
        with pytest.raises(elastic.ElasticResizeError, match=re.escape(str(error))):
            elastic.plan_resize(action, count)
        return
    assert elastic.plan_resize(action, count) == want


@pytest.mark.parametrize("overrides,count", [
    ([], 1), (["arch.mesh.data=8"], 4), (["arch.roles={learner: [0]}"], 4),
    (["arch.mesh.data=4", "arch.mesh.pop=2"], 4)])
def test_topology_and_survivor_overrides_equal_the_jax_package(overrides, count):
    assert elastic.survivor_overrides(count, overrides) == jax_elastic.survivor_overrides(
        count, overrides)
    for root in ("default/anakin/default_ff_ppo.yaml", "default/gossip/default_ff_ppo.yaml"):
        cfg = config_lib.compose(config_lib.default_config_dir(), root, [])
        assert elastic.topology_overrides(cfg, count) == jax_elastic.topology_overrides(cfg, count)
        assert elastic.resize_overrides(cfg, count) == jax_elastic.topology_overrides(cfg, count)


def test_a_population_resize_stays_refused_naming_the_key():
    # The population re-placement is ported: a population run's resize
    # appends the JAX package's population overrides (the port's device count
    # is its process count, one here). What stays refused, naming the key, is
    # a population spread over ranks (arch.mesh.pop above 1), whose rescue
    # store holds no member rows to re-place.
    from stoix_tpu.population import elastic as jax_population_elastic

    cfg = {"arch": {"mesh": {"data": -1}, "population": {
        "size": 4, "hparams": {"system.actor_lr": [1e-3, 2e-3, 3e-3, 4e-3]}}}}
    want = jax_elastic.topology_overrides(cfg, 2) + (
        jax_population_elastic.population_resize_overrides(
            cfg, target_devices=2, from_devices=1, stats={}))
    assert elastic.resize_overrides(cfg, 2) == want
    assert want[-2:] == ["arch.population.size=8",
                         "arch.population.hparams.system.actor_lr="
                         "[0.001,0.002,0.003,0.004,0.004,0.003,0.002,0.001]"]
    spread = {"arch": {**cfg["arch"], "mesh": {"pop": 2, "data": 1}}}
    with pytest.raises(elastic.ElasticResizeError, match=r"arch\.mesh\.pop=2"):
        elastic.resize_overrides(spread, 4)


def test_resize_request_round_trips_and_is_consumed_once(tmp_path):
    directory = str(tmp_path / "emergency")
    path = elastic.write_resize_request(directory, action="shrink", from_devices=2,
                                        target_devices=1, window=0, step=64, platform="cuda",
                                        overrides=["arch.mesh.data=-1"])
    assert os.path.basename(path) == jax_elastic.RESIZE_REQUEST_NAME
    request = jax_elastic.read_resize_request(directory)  # the JAX package reads it
    assert request == elastic.read_resize_request(directory)
    assert (request["action"], request["from_devices"], request["target_devices"],
            request["platform"], request["overrides"]) == ("shrink", 2, 1, "cuda",
                                                            ["arch.mesh.data=-1"])
    assert elastic.consume_resize_request(directory) == request
    assert elastic.read_resize_request(directory) is None
    assert elastic.consume_resize_request(directory) is None


# ------------------------------------------------------------ place_host_leaves


def _template():
    return {"params": {"w": np.zeros((3, 4), np.float32), "b": np.zeros(4, np.float32)},
            "keys": np.zeros((2, 2), np.uint32), "count": np.zeros((), np.int32)}


def _raw(changes=None):
    raw = {("params", "w"): np.arange(12.0, dtype=np.float32).reshape(3, 4),
           ("params", "b"): np.ones(4, np.float32),
           ("keys",): np.full((8, 2), 3, np.uint32), ("count",): np.asarray(5, np.int32)}
    raw.update(changes or {})
    return {k: v for k, v in raw.items() if v is not None}


@pytest.mark.parametrize("case", ["reshard", "missing_allowed"])
def test_place_host_leaves_places_as_the_jax_package(case):
    raw = _raw() if case == "reshard" else _raw({("params", "b"): None})
    allow = case == "missing_allowed"
    tree, matched, _, keys = checkpointing.place_host_leaves(raw, _template(), 7,
                                                             allow_missing=allow)
    want = jax_checkpointing.place_host_leaves(raw, _template(), 7, allow_missing=allow)
    assert matched == want[1] and sorted(keys) == sorted(want[3])
    np.testing.assert_array_equal(tree["params"]["w"], np.asarray(want[0]["params"]["w"]))
    np.testing.assert_array_equal(tree["keys"], np.zeros((2, 2), np.uint32))  # kept the template's
    assert tree["count"] == 5


@pytest.mark.parametrize("case,match", [
    ("dtype", "dtype mismatch"), ("missing", "missing from the checkpoint"),
    ("none_matched", "matched ZERO leaves")])
def test_place_host_leaves_refuses_as_the_jax_package(case, match):
    if case == "dtype":
        raw = _raw({("params", "w"): np.zeros((3, 4), np.float64)})
    elif case == "missing":
        raw = _raw({("params", "b"): None})
    else:
        raw = {("params", "w"): np.zeros((5, 5), np.float32),
               ("params", "b"): np.zeros(9, np.float32),
               ("keys",): np.zeros((8, 2), np.uint32), ("count",): np.zeros(3, np.int32)}
    with pytest.raises(JaxIntegrityError, match=match):
        jax_checkpointing.place_host_leaves(raw, _template(), 7)
    with pytest.raises(CheckpointIntegrityError, match=match):
        checkpointing.place_host_leaves(raw, _template(), 7)


def test_place_host_leaves_fills_tensors_generators_and_kept_paths():
    gen = torch.Generator().manual_seed(4)
    raw = {("w",): torch.arange(3.0), ("g",): {"generator_state": gen.get_state()},
           ("n",): 9, ("env",): torch.ones(2)}
    fresh = torch.Generator().manual_seed(0)
    template = {"w": torch.zeros(3), "g": fresh, "n": 0, "env": torch.zeros(2), "none": None}
    tree, matched, reinit, keys = checkpointing.place_host_leaves(raw, template, 1,
                                                                  keep=[("env",)])
    assert matched == 3 and keys == [("env",)] and "kept the template's" in reinit[0]
    assert torch.equal(tree["w"], torch.arange(3.0)) and tree["n"] == 9 and tree["none"] is None
    assert tree["g"] is fresh and torch.equal(fresh.get_state(), gen.get_state())
    assert torch.equal(tree["env"], torch.zeros(2))


# ------------------------------------------------------------ runs over two ranks


def _replicated(payload: dict) -> dict:
    return {k: v for k, v in payload.items() if k.split("/")[0] in REPLICATED
            and isinstance(v, torch.Tensor)}


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    """A one-process store (one window, uid "one"), then the pair: the
    store restored over two ranks and trained one window (uid "two", the
    two-rank store), then `shrink:0`."""
    root = tmp_path_factory.mktemp("elastic")
    one = root / "one_rank"
    one.mkdir()
    cwd = os.getcwd()
    os.chdir(one)
    try:
        ff_ppo.run_experiment(worker.anakin_config(1, worker.SAVE + [
            "logger.checkpointing.save_args.checkpoint_uid=one"]), device="cpu")
    finally:
        os.chdir(cwd)
    pair = worker.spawn(str(root), "restore_1to2,shrink")
    codes, logs = worker.finish(pair, timeout=180.0)
    outs = [json.loads((root / f"out{r}.json").read_text()) for r in range(2)]
    return {"root": root, "codes": codes, "logs": logs, "outs": outs}


def test_a_one_process_checkpoint_restores_over_two_ranks(elastic_runs):
    root = elastic_runs["root"]
    saved = torch.load(root / "one_rank" / "checkpoints" / "one" / "ff_ppo" / "64" / "state.pt",
                       weights_only=True)
    want = _replicated(saved)
    for rank, out in enumerate(elastic_runs["outs"]):
        report = out["restore_1to2"]["resilience"]["elastic_restore"]
        assert out["restore_1to2"]["resilience"]["restored_step"] == 64
        assert (report["saved_world"], report["world"], report["step"]) == (1, 2, 64)
        assert report["matched"] == len(want) + 2  # the optimizers' host step counts too
        kept = {entry.split(" ")[0].split("/")[0] for entry in report["reinitialized"]}
        assert kept == set(PER_RANK)
        got = torch.load(root / f"out{rank}.json.restore_1to2.{rank}.pt", weights_only=True)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_a_two_rank_checkpoint_restores_in_one_process(elastic_runs, tmp_path, monkeypatch):
    store = elastic_runs["root"] / "checkpoints"
    rank0 = torch.load(store / "two" / "ff_ppo" / "128" / "state.0-of-2.pt", weights_only=True)
    rank1 = torch.load(store / "two" / "ff_ppo" / "128" / "state.1-of-2.pt", weights_only=True)
    want = _replicated(rank0)
    assert all(torch.equal(want[k], rank1[k]) for k in want)  # the replicas agree
    monkeypatch.chdir(tmp_path)
    config = worker.anakin_config(1, worker.SAVE + [
        "logger.checkpointing.load_model=true", f"logger.checkpointing.load_args.load_path={store}",
        "logger.checkpointing.load_args.checkpoint_uid=two",
        "logger.checkpointing.save_args.checkpoint_uid=back_to_one"])
    final, state = worker.run_capturing_first_state(config)
    assert np.isfinite(final)
    got = worker.replicated_leaves(state)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    report = runner.LAST_RUN_STATS["resilience"]["elastic_restore"]
    assert (report["saved_world"], report["world"], report["step"]) == (2, 1, 128)
    assert {e.split(" ")[0].split("/")[0] for e in report["reinitialized"]} == set(PER_RANK)
    # The loader alone, the same.
    loader = checkpointing.Checkpointer("ff_ppo", rel_dir=str(store), checkpoint_uid="two")
    restored, step = loader.restore(state)
    assert step == 128 and loader.last_elastic_restore["matched"] == report["matched"]


@pytest.mark.parametrize("store", ["checkpoint", "emergency"])
def test_a_narrower_network_refuses_a_store_of_another_world(elastic_runs, tmp_path,
                                                             monkeypatch, store):
    """A one-process run whose MLP is narrower than the two-rank store's is
    another state, not another topology: its replicated leaves' shapes
    differ, so both restores refuse it ('structure') instead of starting
    from fresh params and Adam moments under the saved step."""
    root = elastic_runs["root"]
    load = ([f"logger.checkpointing.load_args.load_path={root / 'checkpoints'}",
             "logger.checkpointing.load_args.checkpoint_uid=two"] if store == "checkpoint"
            else [f"logger.checkpointing.load_args.load_path={root / 'emergency_shrink' / 'r0'}"])
    monkeypatch.chdir(tmp_path)
    config = worker.anakin_config(1, [
        "network.actor_network.pre_torso.layer_sizes=[16,16]",
        "network.critic_network.pre_torso.layer_sizes=[16,16]",
        "logger.checkpointing.load_model=true"] + load)
    with pytest.raises(CheckpointIntegrityError) as caught:
        ff_ppo.run_experiment(config, device="cpu")
    if store == "checkpoint":  # the walk rejected every step, each for its structure
        assert "expected a torch.float32 tensor of shape" in str(caught.value)
    else:
        assert caught.value.kind == "structure" and "the store holds shape" in str(caught.value)


def test_shrink_exits_89_with_its_resize_request(elastic_runs):
    assert elastic_runs["codes"] == [EXIT_CODE_ELASTIC_RESIZE] * 2, "\n".join(elastic_runs["logs"])
    config = worker.anakin_config(3, worker.FLEET)
    for rank in range(2):
        directory = elastic_runs["root"] / "emergency_shrink" / f"r{rank}"
        request = jax_elastic.read_resize_request(str(directory))
        assert (request["action"], request["from_devices"], request["target_devices"]) == (
            "shrink", 2, 1)
        assert (request["window"], request["step"], request["platform"]) == (0, 64, "cpu")
        assert request["overrides"] == jax_elastic.topology_overrides(config, 1)
        flight = json.loads((directory / "flight_record.json").read_text())
        assert flightrec.validate_flight_record(flight) == []
        assert flight["exit_code"] == EXIT_CODE_ELASTIC_RESIZE
        assert fleet.emergency_step(str(directory)) == 64
        assert "elastic shrink: 2 -> 1 device(s) at window 0" in elastic_runs["logs"][rank]
