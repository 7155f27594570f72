"""ff_az of the PyTorch port learns IdentityGame on the CPU
(chip_smoke.AZ_IDENTITY: 64 envs, 16 384 steps, 8 simulations) above
chip_smoke.SEARCH_THRESHOLD, 8.0, where the JAX package returns 10.0 for
seeds 42 and 1 (scripts/jax_oracle_thresholds.py --oracles az mz). ff_mz's
oracle (chip_smoke.MZ_IDENTITY: 16 envs, 16 384 steps, 16 epochs) takes
about 130 s on one CPU thread, so it runs on the card alone (chip_smoke.py's
mz_learn)."""

from stoix_tpu_torch.systems.search import ff_az
from stoix_tpu_torch.utils import config as config_lib
import torch_parity  # noqa: F401  (one intra-op thread, as every port test)


def test_az_learns_identity_game():
    import chip_smoke

    cfg = config_lib.compose(config_lib.default_config_dir(), chip_smoke.SEARCH_ROOTS["ff_az"],
                             chip_smoke.AZ_IDENTITY)
    assert ff_az.run_experiment(cfg, device="cpu") > chip_smoke.SEARCH_THRESHOLD
