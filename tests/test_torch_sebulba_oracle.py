"""Sebulba ff_ppo and ff_impala of the PyTorch port learn IdentityGame on the
CPU (chip_smoke.SEBULBA_IDENTITY: 16 envs in two actor threads, 8 192 steps,
every role on device 0) above chip_smoke.SEBULBA_THRESHOLD, 8.0, where the
JAX package returns 10.0 for seeds 42 and 1 in both
(scripts/jax_oracle_thresholds.py --oracles sebulba_ppo sebulba_impala)."""

import pytest

from stoix_tpu_torch.systems.impala.sebulba import ff_impala
from stoix_tpu_torch.systems.ppo.sebulba import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
import torch_parity  # noqa: F401  (one intra-op thread, as every port test)


@pytest.mark.parametrize("oracle", ["sebulba_ppo", "sebulba_impala"])
def test_sebulba_system_learns_identity_game(oracle):
    import chip_smoke

    system, overrides = chip_smoke.SEBULBA_ORACLES[oracle]
    module = {"ff_ppo": ff_ppo, "ff_impala": ff_impala}[system]
    cfg = config_lib.compose(config_lib.default_config_dir(), chip_smoke.SEBULBA_ROOTS[system],
                             overrides)
    assert module.run_experiment(cfg, device="cpu") > chip_smoke.SEBULBA_THRESHOLD
    assert ff_ppo.LAST_RUN_STATS["resilience"]["actor_crashes"] == 0
