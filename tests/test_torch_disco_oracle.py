"""ff_disco103 of the PyTorch port learns IdentityGame on the CPU
(chip_smoke.DISCO_IDENTITY: 64 envs, 131 072 steps, a policy temperature of
16 over [-20, 20], 2 minibatches) above chip_smoke.A13_THRESHOLD, 8.0, where
the JAX package returns 10.0 for seeds 42 and 1
(scripts/jax_oracle_thresholds.py --oracles disco). About 40 s on one CPU
thread. (ff_spo's oracle is in tests/test_torch_spo_sweep.py.)"""

from stoix_tpu_torch.systems.disco import ff_disco103
from stoix_tpu_torch.utils import config as config_lib
import torch_parity  # noqa: F401  (one intra-op thread, as every port test)


def test_disco_learns_identity_game():
    import chip_smoke

    cfg = config_lib.compose(config_lib.default_config_dir(), chip_smoke.DISCO_ROOT,
                             chip_smoke.DISCO_IDENTITY)
    assert ff_disco103.run_experiment(cfg, device="cpu") > chip_smoke.A13_THRESHOLD
