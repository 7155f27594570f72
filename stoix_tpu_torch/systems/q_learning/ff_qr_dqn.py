"""Anakin QR-DQN (counterpart of stoix_tpu/systems/q_learning/ff_qr_dqn.py):
quantile-regression distributional Q-learning (`quantile_q_learning`) with
the QuantileDiscreteQNetwork head."""

from __future__ import annotations

from typing import Any, Union

import torch

from stoix_tpu_torch.base_types import Transition
from stoix_tpu_torch.ops import losses
from stoix_tpu_torch.systems.q_learning.ff_dqn import discounts
from stoix_tpu_torch.systems.q_learning.q_family import run_q_experiment
from stoix_tpu_torch.utils import config as config_lib


def qr_dqn_loss(online_params: Any, target_params: Any, batch: Transition, q_apply, config):
    _, dist_q_tm1, tau_tm1 = q_apply(online_params, batch.obs, 0.0)
    _, dist_q_t, _ = q_apply(target_params, batch.next_obs, 0.0)
    _, dist_q_t_selector, _ = q_apply(online_params, batch.next_obs, 0.0)
    loss = losses.quantile_q_learning(
        dist_q_tm1, tau_tm1, batch.action, batch.reward, discounts(batch, config),
        dist_q_t_selector, dist_q_t,
        huber_param=float(config.system.get("huber_loss_parameter", 1.0)),
    )
    return loss, {"q_loss": loss}


def head_kwargs(config: Any) -> dict:
    return dict(num_quantiles=int(config.system.get("num_quantiles", 51)))


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    return run_q_experiment(config, qr_dqn_loss, head_kwargs=head_kwargs(config),
                            device=device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_qr_dqn.yaml", sys.argv[1:]
    )
    return run_experiment(config)


if __name__ == "__main__":
    main()
