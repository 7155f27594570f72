"""Anakin PPO with continuous actions (counterpart of
stoix_tpu/systems/ppo/anakin/ff_ppo_continuous.py).

ff_ppo's learner unchanged: the squashed-Gaussian (or Beta, or diagonal
Gaussian) head comes from the network config, its bounds from the env's Box
action space, and the float actions [E, A] run through the same rollout,
GAE (one B1 GAE launch an update under `system.multistep_impl: pallas`) and
clipped updates.
"""

from __future__ import annotations

from typing import Any, Union

import torch

from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import learner_setup  # noqa: F401
from stoix_tpu_torch.systems.runner import run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin PPO on continuous actions; returns the final evaluation
    episode-return mean. Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device, outer_axes=("group",))


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_ppo_continuous.yaml",
        sys.argv[1:],
    )
    return run_experiment(config)


if __name__ == "__main__":
    main()
