"""Anakin DPO with continuous actions (counterpart of
stoix_tpu/systems/ppo/anakin/ff_dpo_continuous.py): the drift-based surrogate
(`system.dpo_alpha`, `system.dpo_beta`) in place of the PPO clip, on ff_ppo's
learner."""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.ops import losses
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import learner_setup as _ppo_learner_setup
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib


def dpo_policy_loss(dist: Any, action: torch.Tensor, old_log_prob: torch.Tensor,
                    gae: torch.Tensor, config: Any, behavior_dist: Optional[Any] = None,
                    beta: Optional[Any] = None):
    """(loss, entropy) of the DPO surrogate; its drift uses the stored
    log-probs, not the behaviour distribution or β."""
    del behavior_dist, beta
    log_prob = dist.log_prob(action)
    loss = losses.dpo_loss(
        log_prob, old_log_prob, gae,
        float(config.system.get("dpo_alpha", 2.0)), float(config.system.get("dpo_beta", 0.6)),
    )
    return loss, dist.entropy().mean()


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    return _ppo_learner_setup(env, config, device, seed, policy_loss_fn=dpo_policy_loss)


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin DPO on continuous actions; returns the final evaluation
    episode-return mean. Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device, outer_axes=("group",))


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_dpo_continuous.yaml",
        sys.argv[1:],
    )
    return run_experiment(config)


if __name__ == "__main__":
    main()
