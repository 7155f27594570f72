"""Anakin SPO with continuous actions (counterpart of
stoix_tpu/systems/spo/ff_spo_continuous.py): the learner of ff_spo.py; the
tanh-Gaussian head comes from `network: mlp_continuous`."""

from __future__ import annotations

from typing import Any, Union

import torch

from stoix_tpu_torch.systems.runner import run_anakin_experiment
from stoix_tpu_torch.systems.spo.ff_spo import learner_setup
from stoix_tpu_torch.utils import config as config_lib


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin SPO on a continuous action space; returns the final
    evaluation episode-return mean. Runs on CUDA unless the caller asks for
    another device."""
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/anakin/default_ff_spo_continuous.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
