"""Anakin AWR, continuous actions (counterpart of
stoix_tpu/systems/awr/ff_awr_continuous.py): ff_awr's learner;
the continuous head (`network=mlp_continuous`) comes from the config."""

from __future__ import annotations

from typing import Any, Union

import torch

from stoix_tpu_torch.systems.runner import run_anakin_experiment
from stoix_tpu_torch.systems.awr.ff_awr import learner_setup  # noqa: F401
from stoix_tpu_torch.utils import config as config_lib


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_awr_continuous.yaml",
        sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
