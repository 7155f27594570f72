"""Multi-sink experiment logger (counterpart of stoix_tpu/utils/logger.py).

Metric names and summaries are the JAX package's: TRAIN events and single
values log their mean; other array metrics log `name/mean`, `name/std`,
`name/min` and `name/max` over their finite entries; EVAL and ABSOLUTE
events add `solve_rate` when the env config names a solve threshold. The
sinks are the JAX package's, under the same config keys and writing the same
files: the console, JSON in the marl-eval layout (`use_json`), TensorBoard
(`use_tb`), and the offline run directories of the W&B (`use_wandb`) and
neptune (`use_neptune`) sinks, which the JAX package writes when those
packages are absent; the port always writes those directories and never
calls the packages. Every logged record is also kept in
`StoixLogger.history`. With `logger.telemetry.enabled` a TelemetrySink
(observability/sink.py) writes `metrics.prom`, `metrics.jsonl` and, at
close, the span trace `trace.json` under `logger.telemetry.dir` (default
`<exp_dir>/telemetry`); `observability.configure` is called once a logger,
as the JAX logger calls it, and is the run's reset of the flight recorder.
`logger.telemetry.http.enabled` starts the HTTP ops plane (observability/httpz.py)
through the same `configure`, on every rank.

Over several processes only the coordinator (rank 0) has sinks, as the JAX
runner logs only on its coordinator: the other ranks write no file and print
nothing, and keep `history` all the same (the runner logs global metrics,
the same on every rank).
"""

from __future__ import annotations

import enum
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from stoix_tpu_torch import observability
from stoix_tpu_torch.parallel.distributed import is_coordinator


class LogEvent(enum.Enum):
    ACT = "actor"
    TRAIN = "trainer"
    EVAL = "evaluator"
    ABSOLUTE = "absolute"
    MISC = "misc"  # Sebulba's timings


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def describe(x: Any) -> Dict[str, float]:
    arr = _to_numpy(x).astype(np.float32).reshape(-1)
    # One non-finite episode metric must not poison all four summary stats.
    finite = arr[np.isfinite(arr)]
    if finite.size == 0:
        return {} if arr.size == 0 else {"non_finite_count": float(arr.size)}
    stats = {
        "mean": float(finite.mean()),
        "std": float(finite.std()),
        "min": float(finite.min()),
        "max": float(finite.max()),
    }
    if finite.size != arr.size:
        stats["non_finite_count"] = float(arr.size - finite.size)
    return stats


class BaseSink:
    def write(self, metrics: Dict[str, float], t: int, t_eval: int, event: LogEvent) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ConsoleSink(BaseSink):
    def write(self, metrics: Dict[str, float], t: int, t_eval: int, event: LogEvent) -> None:
        parts = " | ".join(
            f"{k.replace('_', ' ').title()}: {v:.3f}" for k, v in sorted(metrics.items())
        )
        print(f"[{event.value.upper()} t={t}] {parts}", flush=True)


class JsonSink(BaseSink):
    """marl-eval JSON: {env}/{task}/{system}/seed_{n} with per-eval-step
    metric lists, restricted to episode_return, solve_rate and
    steps_per_second on EVAL and ABSOLUTE events."""

    def __init__(self, path: str, env_name: str, task_name: str, system_name: str, seed: int):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._keys = (env_name, task_name, system_name, f"seed_{seed}")
        self._data: Dict[str, Any] = {}
        node = self._data
        for k in self._keys[:-1]:
            node = node.setdefault(k, {})
        node[self._keys[-1]] = {}

    def _leaf(self) -> Dict[str, Any]:
        node = self._data
        for k in self._keys[:-1]:
            node = node[k]
        return node[self._keys[-1]]

    def write(self, metrics: Dict[str, float], t: int, t_eval: int, event: LogEvent) -> None:
        if event not in (LogEvent.EVAL, LogEvent.ABSOLUTE):
            return
        leaf = self._leaf()
        step_key = "absolute_metrics" if event == LogEvent.ABSOLUTE else f"step_{t_eval}"
        entry = leaf.setdefault(step_key, {"step_count": t})
        for k, v in metrics.items():
            if k.startswith("episode_return") or k in ("solve_rate", "steps_per_second"):
                entry.setdefault(k, []).append(float(v))
        with open(self._path, "w") as f:
            json.dump(self._data, f, indent=2)


class TensorboardSink(BaseSink):
    """Scalars under `<event>/<name>` at step t. Needs the tensorboard
    package; without it, raises naming it."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as missing:
            raise ImportError(
                "logger.use_tb=true needs the tensorboard package, which is not installed"
            ) from missing
        self._writer = SummaryWriter(log_dir=logdir)

    def write(self, metrics: Dict[str, float], t: int, t_eval: int, event: LogEvent) -> None:
        for k, v in metrics.items():
            self._writer.add_scalar(f"{event.value}/{k}", float(v), t)

    def close(self) -> None:
        self._writer.close()


class _OfflineRunDir:
    """A run directory with a metadata JSON and an append-mode history.jsonl
    (append, so a resumed run id continues the file)."""

    def __init__(self, base: str, metadata: Dict[str, Any], metadata_name: str,
                 history_name: str, files_subdir: Optional[str] = None):
        self.dir = base
        self.files_dir = os.path.join(base, files_subdir) if files_subdir else base
        os.makedirs(self.files_dir, exist_ok=True)
        with open(os.path.join(self.files_dir, metadata_name), "w") as f:
            json.dump(metadata, f, indent=2)
        self._history = open(os.path.join(base, history_name), "a")

    def write_row(self, row: Dict[str, Any]) -> None:
        self._history.write(json.dumps(row) + "\n")
        self._history.flush()

    def close(self) -> None:
        self._history.close()


class WandbSink(BaseSink):
    """A wandb-format offline run directory, as the JAX package's WandbSink
    writes it without the wandb package:

        <dir>/offline-run-<stamp>/files/wandb-metadata.json   (run metadata)
        <dir>/offline-run-<stamp>/files/config.yaml           (run config)
        <dir>/offline-run-<stamp>/files/wandb-summary.json    (latest values)
        <dir>/offline-run-<stamp>/wandb-history.jsonl         (rows keyed by _step)
    """

    def __init__(self, run_dir: str, project: str = "stoix_tpu", mode: str = "offline",
                 config_dict: Optional[Dict[str, Any]] = None, **init_kwargs: Any):
        self._start = time.time()
        self._summary: Dict[str, Any] = {}
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self._offline = _OfflineRunDir(
            base=os.path.join(run_dir, f"offline-run-{stamp}"),
            metadata={
                "project": project,
                "mode": mode,
                "startedAt": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "writer": "stoix_tpu_torch.WandbSink (an offline run directory)",
            },
            metadata_name="wandb-metadata.json",
            history_name="wandb-history.jsonl",
            files_subdir="files",
        )
        if config_dict is not None:
            import yaml

            with open(os.path.join(self._offline.files_dir, "config.yaml"), "w") as f:
                yaml.safe_dump(json.loads(json.dumps(config_dict, default=str)), f)

    def write(self, metrics: Dict[str, float], t: int, t_eval: int, event: LogEvent) -> None:
        row: Dict[str, Any] = {f"{event.value}/{k}": v for k, v in metrics.items()}
        now = time.time()
        row.update({"_step": t, "_runtime": now - self._start, "_timestamp": now})
        self._offline.write_row(row)
        self._summary.update(row)
        with open(os.path.join(self._offline.files_dir, "wandb-summary.json"), "w") as f:
            json.dump(self._summary, f)

    def close(self) -> None:
        self._offline.close()


class NeptuneSink(BaseSink):
    """A neptune-format offline run directory, as the JAX package's
    NeptuneSink writes it without the neptune package:

        <dir>/neptune-run-<run_id or stamp>/run-metadata.json
        <dir>/neptune-run-<run_id or stamp>/history.jsonl   (rows {key, value, step})

    Only main metrics (scalars and `/mean`) unless `detailed_logging`."""

    def __init__(self, run_dir: str, project: str = "stoix_tpu", tag: Optional[list] = None,
                 group_tag: Optional[list] = None, detailed_logging: bool = False,
                 architecture_name: str = "anakin", run_id: Optional[str] = None,
                 **init_kwargs: Any):
        self._detailed = bool(detailed_logging)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self._offline = _OfflineRunDir(
            base=os.path.join(run_dir, f"neptune-run-{run_id or stamp}"),
            metadata={
                "project": project,
                "mode": "async" if architecture_name == "anakin" else "sync",
                "tags": list(tag or []),
                "group_tags": list(group_tag or []),
                "resumed_run_id": run_id,
                "startedAt": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "writer": "stoix_tpu_torch.NeptuneSink (an offline run directory)",
            },
            metadata_name="run-metadata.json",
            history_name="history.jsonl",
        )

    def write(self, metrics: Dict[str, float], t: int, t_eval: int, event: LogEvent) -> None:
        for k, v in metrics.items():
            if not self._detailed and not ("/" not in k or k.endswith("/mean")):
                continue
            self._offline.write_row({"key": f"{event.value}/{k}", "value": float(v), "step": t})

    def close(self) -> None:
        self._offline.close()


class StoixLogger:
    """Summarises raw (possibly tensor-valued) metrics, fans them out to the
    configured sinks, and keeps every record in `history`."""

    def __init__(self, config: Any):
        logger_cfg = config.logger
        telemetry_cfg = dict(logger_cfg.get("telemetry") or {})
        # Only the coordinator has sinks, so only it records spans; every
        # rank resets its flight recorder.
        telemetry = observability.configure(
            telemetry_cfg if is_coordinator() else {**telemetry_cfg, "enabled": False})
        env_name = config.env.get("env_name", "env")
        task_name = (config.env.get("scenario") or {}).get("task_name", "task")
        system_name = logger_cfg.get("system_name") or "system"
        seed = int(config.arch.seed)
        stamp = time.strftime("%Y%m%d%H%M%S")
        self.exp_dir = os.path.join(
            logger_cfg.get("base_exp_path", "results"), f"{system_name}", f"{task_name}",
            f"seed_{seed}_{stamp}",
        )
        self._sinks: List[BaseSink] = []
        threshold = config.env.get("solved_return_threshold")
        self._solve_threshold: Optional[float] = None if threshold is None else float(threshold)
        self.history: List[Dict[str, Any]] = []
        if not is_coordinator():
            return
        if logger_cfg.get("use_console", True):
            self._sinks.append(ConsoleSink())
        if logger_cfg.get("use_json", False):
            json_path = (logger_cfg.get("kwargs") or {}).get("json_path") or os.path.join(
                self.exp_dir, "metrics.json")
            self._sinks.append(JsonSink(json_path, env_name, task_name, system_name, seed))
        if logger_cfg.get("use_tb", False):
            self._sinks.append(TensorboardSink(os.path.join(self.exp_dir, "tb")))
        if logger_cfg.get("use_wandb", False):
            kwargs = dict(logger_cfg.get("wandb_kwargs") or {})
            kwargs.setdefault("project", "stoix_tpu")
            snapshot = config.to_dict() if hasattr(config, "to_dict") else None
            self._sinks.append(
                WandbSink(os.path.join(self.exp_dir, "wandb"), config_dict=snapshot, **kwargs))
        if logger_cfg.get("use_neptune", False):
            kwargs = dict(logger_cfg.get("neptune_kwargs") or {})
            kwargs.setdefault("project", "stoix_tpu")
            kwargs.setdefault("tag", (logger_cfg.get("kwargs") or {}).get("neptune_tag") or [])
            kwargs.setdefault("architecture_name",
                              (config.get("arch") or {}).get("architecture_name", "anakin"))
            self._sinks.append(NeptuneSink(os.path.join(self.exp_dir, "neptune"), **kwargs))
        if telemetry:
            from stoix_tpu_torch.observability.sink import TelemetrySink

            self._sinks.append(TelemetrySink(
                telemetry_cfg.get("dir") or os.path.join(self.exp_dir, "telemetry"),
                min_write_interval_s=float(telemetry_cfg.get("min_write_interval_s", 0.0) or 0.0),
            ))

    def log(self, metrics: Dict[str, Any], t: int, t_eval: int, event: LogEvent) -> None:
        processed: Dict[str, float] = {}
        for k, v in metrics.items():
            arr = _to_numpy(v)
            if arr.size == 0:
                continue
            if event == LogEvent.TRAIN or arr.size == 1:
                processed[k] = float(arr.mean())
            else:
                for stat, val in describe(arr).items():
                    processed[f"{k}/{stat}"] = val
        if (
            self._solve_threshold is not None
            and event in (LogEvent.EVAL, LogEvent.ABSOLUTE)
            and "episode_return" in metrics
        ):
            returns = _to_numpy(metrics["episode_return"]).reshape(-1)
            if returns.size:
                processed["solve_rate"] = float((returns >= self._solve_threshold).mean() * 100.0)
        self.history.append({"event": event.value, "t": t, "t_eval": t_eval, **processed})
        for sink in self._sinks:
            sink.write(processed, t, t_eval, event)

    def close(self) -> None:
        for sink in self._sinks:
            sink.close()
