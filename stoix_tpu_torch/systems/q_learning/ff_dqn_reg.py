"""Anakin DQN-Reg (counterpart of stoix_tpu/systems/q_learning/ff_dqn_reg.py):
DQN with a term that penalises Q(s, a) directly,
loss = mean(reg . Q(s, a) + 0.5 td^2) (Co-Reyes et al., Evolving RL Algorithms)."""

from __future__ import annotations

from typing import Any, Union

import torch

from stoix_tpu_torch.base_types import Transition
from stoix_tpu_torch.systems.q_learning.ff_dqn import discounts
from stoix_tpu_torch.systems.q_learning.q_family import run_q_experiment
from stoix_tpu_torch.utils import config as config_lib


def dqn_reg_loss(online_params: Any, target_params: Any, batch: Transition, q_apply, config):
    q_tm1 = q_apply(online_params, batch.obs, 0.0).preferences
    q_t = q_apply(target_params, batch.next_obs, 0.0).preferences
    qa_tm1 = torch.gather(q_tm1, -1, batch.action.long()[..., None])[..., 0]
    target = (batch.reward + discounts(batch, config) * torch.amax(q_t, dim=-1)).detach()
    td = target - qa_tm1
    reg = float(config.system.get("regularizer_coeff", 0.1))
    loss = torch.mean(reg * qa_tm1 + 0.5 * td**2)
    return loss, {"q_loss": loss, "mean_q": torch.mean(q_tm1)}


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    return run_q_experiment(config, dqn_reg_loss, device=device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_dqn_reg.yaml", sys.argv[1:]
    )
    return run_experiment(config)


if __name__ == "__main__":
    main()
