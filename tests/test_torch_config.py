"""The PyTorch port's config tree against the JAX package's: for every group
the slice carries, the same keys and values, with only `_target_` re-pointed
from `stoix_tpu.` to `stoix_tpu_torch.`, and every `_target_` importable."""

import pytest

from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch.utils import config as config_lib

ROOT = "default/anakin/default_ff_ppo.yaml"


def _repointed(tree):
    if isinstance(tree, dict):
        return {k: (v.replace("stoix_tpu.", "stoix_tpu_torch.", 1) if k == "_target_" else
                    _repointed(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_repointed(v) for v in tree]
    return tree


def _targets(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "_target_":
                yield v
            else:
                yield from _targets(v)


@pytest.mark.parametrize("overrides", [[], ["env=identity_game"]])
def test_config_tree_mirrors_the_jax_package(overrides):
    port = config_lib.compose(config_lib.default_config_dir(), ROOT, overrides).to_dict()
    ref = jax_config.compose(jax_config.default_config_dir(), ROOT, overrides).to_dict()
    assert port == _repointed(ref)
    for target in _targets(port):
        assert target.startswith("stoix_tpu_torch.")
        config_lib._import_target(target)


def test_overrides_and_instantiate_work_on_the_port_tree():
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOT,
                             ["system.gamma=0.5", "arch.seed=7"])
    assert cfg.system.gamma == 0.5 and cfg.arch.seed == 7
    head = config_lib.instantiate(cfg.network.critic_network.critic_head, input_dim=4)
    assert type(head).__module__ == "stoix_tpu_torch.networks.heads"
