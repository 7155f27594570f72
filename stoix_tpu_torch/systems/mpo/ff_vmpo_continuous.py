"""Anakin V-MPO, continuous actions (counterpart of
stoix_tpu/systems/mpo/ff_vmpo_continuous.py): ff_vmpo's learner; the
squashed-Gaussian head (`network: mlp_vmpo_continuous`) comes from the
config, and the KL trust region takes per-dimension mean and stddev alphas."""

from __future__ import annotations

from typing import Any, Union

import torch

from stoix_tpu_torch.systems.mpo.ff_vmpo import learner_setup  # noqa: F401
from stoix_tpu_torch.systems.runner import run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_vmpo_continuous.yaml",
        sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
