"""The logger's sinks in the PyTorch port (stoix_tpu_torch/utils/logger.py)
against the JAX package's (stoix_tpu/utils/logger.py), fed the same metrics:
the JSON file (the marl-eval layout) is equal; the wandb and neptune offline
run directories hold the same files and the same rows (wall-clock keys
aside); both TensorBoard sinks write an events file; without tensorboard the
port raises naming the package; the runner writes the JSON and wandb files.
"""

import builtins
import glob
import json
import os

import numpy as np
import pytest
import torch

from stoix_tpu.utils import config as jax_config
from stoix_tpu.utils import logger as jlogger
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils import logger as tlogger

CLOCK_KEYS = ("_runtime", "_timestamp")


def _config(root, **logger_overrides):
    tree = {
        "logger": {
            "base_exp_path": str(root), "use_console": False, "use_json": False,
            "use_tb": False, "kwargs": {"json_path": None}, "system_name": "test_system",
            "checkpointing": {"save_model": False},
        },
        "env": {"env_name": "classic", "scenario": {"name": "CartPole-v1", "task_name": "cartpole"},
                "solved_return_threshold": 100.0},
        "arch": {"seed": 0},
    }
    cfg = jax_config.Config.from_dict(tree)
    cfg.logger.update(logger_overrides)
    return cfg


def _feed(logger, tensors):
    as_ = (lambda x: torch.as_tensor(x)) if tensors else np.asarray
    returns = np.array([50.0, 150.0, 200.0, 90.0], np.float32)
    logger.log({"episode_return": as_(returns), "episode_length": as_(np.array([3, 4, 5, 6]))},
               t=1000, t_eval=0, event=jlogger.LogEvent.EVAL if not tensors
               else tlogger.LogEvent.EVAL)
    event = tlogger.LogEvent if tensors else jlogger.LogEvent
    logger.log({"loss": as_(np.array([0.5, 1.5], np.float32))}, t=1000, t_eval=0,
               event=event.TRAIN)
    logger.log({"episode_return": as_(returns + 100)}, t=2000, t_eval=1, event=event.EVAL)
    logger.log({"episode_return": as_(returns)}, t=3000, t_eval=2, event=event.ABSOLUTE)
    logger.close()


def _both(tmp_path, **overrides):
    jax_cfg = _config(tmp_path / "jax", **overrides)
    port_cfg = _config(tmp_path / "port", **overrides)
    want, got = jlogger.StoixLogger(jax_cfg), tlogger.StoixLogger(port_cfg)
    _feed(want, tensors=False)
    _feed(got, tensors=True)
    return want, got


def test_json_sink_writes_the_jax_file(tmp_path):
    want, got = _both(tmp_path, use_json=True)
    read = lambda logger: json.load(open(os.path.join(logger.exp_dir, "metrics.json")))  # noqa
    data = read(got)
    assert data == read(want)
    leaf = data["classic"]["cartpole"]["test_system"]["seed_0"]
    assert leaf["step_0"]["solve_rate"] == [50.0] and leaf["absolute_metrics"]["step_count"] == 3000


def _rows(path):
    return [{k: v for k, v in json.loads(line).items() if k not in CLOCK_KEYS}
            for line in open(path)]


def test_wandb_offline_sink_writes_the_jax_directory(tmp_path):
    want, got = _both(tmp_path, use_wandb=True, wandb_kwargs={"project": "proj_x"})
    runs = []
    for logger in (want, got):
        found = glob.glob(os.path.join(logger.exp_dir, "wandb", "offline-run-*"))
        assert len(found) == 1
        runs.append(found[0])
    assert _rows(os.path.join(runs[1], "wandb-history.jsonl")) == _rows(
        os.path.join(runs[0], "wandb-history.jsonl"))
    assert sorted(os.listdir(os.path.join(runs[1], "files"))) == sorted(
        os.listdir(os.path.join(runs[0], "files")))
    meta = json.load(open(os.path.join(runs[1], "files", "wandb-metadata.json")))
    assert meta["project"] == "proj_x" and meta["mode"] == "offline"
    summary = json.load(open(os.path.join(runs[1], "files", "wandb-summary.json")))
    assert summary["_step"] == 3000


def test_neptune_offline_sink_writes_the_jax_directory(tmp_path):
    kwargs = {"project": "proj_n", "tag": ["t1"], "group_tag": ["g1"], "run_id": "RUN-7"}
    want, got = _both(tmp_path, use_neptune=True, neptune_kwargs=kwargs)
    paths = [os.path.join(logger.exp_dir, "neptune", "neptune-run-RUN-7") for logger in
             (want, got)]
    assert _rows(os.path.join(paths[1], "history.jsonl")) == _rows(
        os.path.join(paths[0], "history.jsonl"))
    meta = [json.load(open(os.path.join(p, "run-metadata.json"))) for p in paths]
    for key in ("project", "mode", "tags", "group_tags", "resumed_run_id"):
        assert meta[1][key] == meta[0][key], key


def test_tensorboard_sink_writes_events(tmp_path):
    want, got = _both(tmp_path, use_tb=True)
    for logger in (want, got):
        assert any(f.startswith("events") for f in os.listdir(os.path.join(logger.exp_dir, "tb")))


def test_tensorboard_missing_raises_naming_the_package(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name == "torch.utils.tensorboard":
            raise ImportError("No module named 'tensorboard'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with pytest.raises(ImportError, match="needs the tensorboard package"):
        tlogger.StoixLogger(_config(tmp_path, use_tb=True))


def test_console_and_history_keep_the_jax_summaries(tmp_path, capsys):
    logger = tlogger.StoixLogger(_config(tmp_path, use_console=True))
    logger.log({"loss": torch.tensor([1.0, 3.0])}, t=1, t_eval=0, event=tlogger.LogEvent.TRAIN)
    assert "Loss: 2.000" in capsys.readouterr().out
    logger.log({"episode_return": torch.tensor([1.0, np.nan, 3.0])}, t=2, t_eval=0,
               event=tlogger.LogEvent.EVAL)
    assert logger.history[-1]["episode_return/mean"] == 2.0
    assert logger.history[-1]["episode_return/non_finite_count"] == 1.0
    assert tlogger.describe(np.array([2.0, np.inf])) == jlogger.describe(np.array([2.0, np.inf]))


def test_the_runner_writes_json_and_wandb_files(tmp_path):
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/anakin/default_ff_ppo.yaml", [
        "env=identity_game", "arch.total_num_envs=8", "arch.num_updates=2",
        "arch.num_evaluation=2", "arch.num_eval_episodes=4", "system.rollout_length=4",
        "system.epochs=1", "system.num_minibatches=2", "logger.use_console=False",
        "logger.use_json=true", "logger.use_wandb=true", f"logger.base_exp_path={tmp_path}"])
    ff_ppo.run_experiment(config, device="cpu")
    (metrics,) = glob.glob(os.path.join(tmp_path, "ff_ppo", "identity_game", "*", "metrics.json"))
    leaf = json.load(open(metrics))["debug"]["identity_game"]["ff_ppo"]["seed_42"]
    assert set(leaf) == {"step_0", "step_1", "absolute_metrics"}
    (history,) = glob.glob(os.path.join(tmp_path, "**", "wandb-history.jsonl"), recursive=True)
    events = {key.split("/")[0] for row in _rows(history) for key in row if "/" in key}
    assert events == {"actor", "trainer", "evaluator", "absolute"}
