"""Anakin DQN (counterpart of stoix_tpu/systems/q_learning/ff_dqn.py): the
item buffer, the warmup fill, the Polyak target update and epsilon-greedy
acting of q_family.py, with the one-step Q-learning loss."""

from __future__ import annotations

from typing import Any, Union

import torch

from stoix_tpu_torch.base_types import Transition
from stoix_tpu_torch.ops import losses
from stoix_tpu_torch.systems.q_learning.q_family import run_q_experiment
from stoix_tpu_torch.utils import config as config_lib


def discounts(batch: Transition, config: Any) -> torch.Tensor:
    """gamma . (1 - done), as the JAX systems form d_t."""
    return float(config.system.gamma) * (1.0 - batch.done.to(torch.float32))


def dqn_loss(online_params: Any, target_params: Any, batch: Transition, q_apply, config):
    q_tm1 = q_apply(online_params, batch.obs, 0.0).preferences
    q_t = q_apply(target_params, batch.next_obs, 0.0).preferences
    loss = losses.q_learning(
        q_tm1, batch.action, batch.reward, discounts(batch, config), q_t,
        use_huber=bool(config.system.get("use_huber", False)),
        huber_delta=float(config.system.get("huber_loss_parameter", 1.0)),
    )
    return loss, {"q_loss": loss, "mean_q": torch.mean(q_tm1)}


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    return run_q_experiment(config, dqn_loss, device=device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_dqn.yaml", sys.argv[1:]
    )
    return run_experiment(config)


if __name__ == "__main__":
    main()
