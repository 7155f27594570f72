"""Console and in-memory logging (counterpart of the console subset of
stoix_tpu/utils/logger.py).

Metric names and summaries are the JAX package's: TRAIN events and single
values log their mean; other array metrics log `name/mean`, `name/std`,
`name/min` and `name/max` over their finite entries; EVAL and ABSOLUTE
events add `solve_rate` when the env config names a solve threshold. Every
logged record is also kept in `StoixLogger.history`.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_UNPORTED_SINKS = ("use_json", "use_tb", "use_wandb", "use_neptune")


class LogEvent(enum.Enum):
    ACT = "actor"
    TRAIN = "trainer"
    EVAL = "evaluator"
    ABSOLUTE = "absolute"


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


class StoixLogger:
    """Summarises raw (possibly tensor-valued) metrics, prints them when
    `logger.use_console` is set, and keeps every record in `history`."""

    def __init__(self, config: Any):
        logger_cfg = config.logger
        unported = [k for k in _UNPORTED_SINKS if logger_cfg.get(k, False)]
        if (logger_cfg.get("telemetry") or {}).get("enabled", False):
            unported.append("telemetry.enabled")
        if unported:
            raise NotImplementedError(
                "logger sinks not ported: " + ", ".join(f"logger.{k}" for k in unported)
            )
        self._console = bool(logger_cfg.get("use_console", True))
        threshold = config.env.get("solved_return_threshold")
        self._solve_threshold: Optional[float] = None if threshold is None else float(threshold)
        self.history: List[Dict[str, Any]] = []

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
        if self._console:
            parts = " | ".join(
                f"{k.replace('_', ' ').title()}: {v:.3f}" for k, v in sorted(processed.items())
            )
            print(f"[{event.value.upper()} t={t}] {parts}", flush=True)
