"""Anakin C51 (counterpart of stoix_tpu/systems/q_learning/ff_c51.py):
categorical distributional Q-learning with a double-Q projection target
(`categorical_double_q_learning`) and the DistributionalDiscreteQNetwork head."""

from __future__ import annotations

from typing import Any, Union

import torch

from stoix_tpu_torch.base_types import Transition
from stoix_tpu_torch.ops import losses
from stoix_tpu_torch.systems.q_learning.ff_dqn import discounts
from stoix_tpu_torch.systems.q_learning.q_family import run_q_experiment
from stoix_tpu_torch.utils import config as config_lib


def c51_loss(online_params: Any, target_params: Any, batch: Transition, q_apply, config):
    _, q_logits_tm1, q_atoms_tm1 = q_apply(online_params, batch.obs, 0.0)
    _, q_logits_t, q_atoms_t = q_apply(target_params, batch.next_obs, 0.0)
    # Double-Q: the ONLINE network selects the bootstrap action, the target
    # network evaluates it.
    dist_selector, _, _ = q_apply(online_params, batch.next_obs, 0.0)
    loss = losses.categorical_double_q_learning(
        q_logits_tm1, q_atoms_tm1, batch.action, batch.reward, discounts(batch, config),
        q_logits_t, q_atoms_t, dist_selector.preferences,
    )
    return loss, {"q_loss": loss}


def head_kwargs(config: Any) -> dict:
    return dict(
        num_atoms=int(config.system.get("num_atoms", 51)),
        vmin=float(config.system.get("vmin", -10.0)),
        vmax=float(config.system.get("vmax", 10.0)),
    )


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    return run_q_experiment(config, c51_loss, head_kwargs=head_kwargs(config), device=device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_c51.yaml", sys.argv[1:]
    )
    return run_experiment(config)


if __name__ == "__main__":
    main()
