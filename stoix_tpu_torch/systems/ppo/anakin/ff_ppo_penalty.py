"""Anakin PPO-penalty (counterpart of
stoix_tpu/systems/ppo/anakin/ff_ppo_penalty.py): a KL-penalty surrogate in
place of the clip, on ff_ppo's learner.

The KL to the behaviour policy (the rollout's params on the same
observations) is the analytic divergence where the distribution has one
(Categorical, the diagonal Gaussian); where its `kl_divergence` raises
NotImplementedError (TanhNormal, Beta) it is the k3 estimator
exp(r) - 1 - r of the clamped log-ratio r. β is the learner state's
`kl_beta` (`system.kl_beta`, 3.0 by default), adapted under
`system.adaptive_kl_beta`.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.ops import losses
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import learner_setup as _ppo_learner_setup
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib


def penalty_policy_loss(dist: Any, action: torch.Tensor, old_log_prob: torch.Tensor,
                        gae: torch.Tensor, config: Any, behavior_dist: Optional[Any] = None,
                        beta: Optional[Any] = None):
    """(loss, entropy) of the KL-penalty surrogate, as the JAX package's."""
    log_prob = dist.log_prob(action)
    kl = None
    if behavior_dist is not None:
        try:
            kl = behavior_dist.kl_divergence(dist)
        except NotImplementedError:  # no closed form: the k3 estimator below
            kl = None
    if kl is None:
        log_ratio = torch.clamp(log_prob - old_log_prob, -losses._LOG_RATIO_CLAMP,
                                losses._LOG_RATIO_CLAMP)
        kl = torch.exp(log_ratio) - 1.0 - log_ratio
    if beta is None:
        beta = float(config.system.get("kl_beta", 3.0))
    loss = losses.ppo_penalty_loss(log_prob, old_log_prob, gae, beta, kl)
    return loss, dist.entropy().mean()


# The loss consumes the kl_beta learner state, which lets
# system.adaptive_kl_beta through (ff_ppo's learner refuses it otherwise).
penalty_policy_loss.uses_kl_beta = True


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    return _ppo_learner_setup(env, config, device, seed, policy_loss_fn=penalty_policy_loss)


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin PPO-penalty; returns the final evaluation episode-return
    mean. Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device, outer_axes=("group",))


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_ppo_penalty.yaml",
        sys.argv[1:],
    )
    return run_experiment(config)


if __name__ == "__main__":
    main()
