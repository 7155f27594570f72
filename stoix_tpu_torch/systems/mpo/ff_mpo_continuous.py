"""Anakin MPO, continuous actions (counterpart of
stoix_tpu/systems/mpo/ff_mpo_continuous.py): ff_mpo's learner; the
squashed-Gaussian actor and the Q(s, a) critic (`network: mlp_mpo_continuous`) come
from the config; the E-step runs over `num_samples` sampled actions."""

from __future__ import annotations

from typing import Any, Union

import torch

from stoix_tpu_torch.systems.mpo.ff_mpo import learner_setup  # noqa: F401
from stoix_tpu_torch.systems.runner import run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_mpo_continuous.yaml",
        sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
