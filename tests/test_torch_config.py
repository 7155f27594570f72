"""The PyTorch port's config tree against the JAX package's: for every group
the slice carries, the same keys and values, with only `_target_` re-pointed
from `stoix_tpu.` to `stoix_tpu_torch.`, and every `_target_` importable."""

import pytest

from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch.utils import config as config_lib

ROOT = "default/anakin/default_ff_ppo.yaml"
TRANS_ROOT = "default/anakin/default_ff_trans_ppo.yaml"


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


def _assert_mirrors(root, overrides):
    port = config_lib.compose(config_lib.default_config_dir(), root, overrides).to_dict()
    ref = jax_config.compose(jax_config.default_config_dir(), root, overrides).to_dict()
    assert port == _repointed(ref)
    for target in _targets(port):
        assert target.startswith("stoix_tpu_torch.")
        config_lib._import_target(target)


@pytest.mark.parametrize("overrides", [[], ["env=identity_game"]])
def test_config_tree_mirrors_the_jax_package(overrides):
    _assert_mirrors(ROOT, overrides)


@pytest.mark.parametrize("overrides", [[], ["env=identity_game", "system.window_length=4"]])
def test_trans_config_tree_mirrors_the_jax_package(overrides):
    _assert_mirrors(TRANS_ROOT, overrides)


# The value-based family's roots (each composes its system/q_learning and
# network/mlp_{dqn,pqn,c51,qr_dqn} groups).
Q_ROOTS = [f"default/anakin/default_ff_{name}.yaml"
           for name in ("dqn", "ddqn", "dqn_reg", "mdqn", "c51", "qr_dqn", "pqn")]


@pytest.mark.parametrize("root", Q_ROOTS)
@pytest.mark.parametrize("overrides", [[], ["env=identity_game", "system.multistep_impl=pallas"]])
def test_q_family_config_trees_mirror_the_jax_package(root, overrides):
    _assert_mirrors(root, overrides)


def test_overrides_and_instantiate_work_on_the_port_tree():
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOT,
                             ["system.gamma=0.5", "arch.seed=7"])
    assert cfg.system.gamma == 0.5 and cfg.arch.seed == 7
    head = config_lib.instantiate(cfg.network.critic_network.critic_head, input_dim=4)
    assert type(head).__module__ == "stoix_tpu_torch.networks.heads"


# The continuous and penalty PPO family and recurrent PPO: each root as it
# is, and with `multistep_impl=pallas` and its other groups and options.
PPO_FAMILY = {
    "ff_ppo_continuous": ["network=mlp_mvn_continuous", "env=mountain_car_continuous"],
    "ff_ppo_penalty": ["env=identity_game", "system.adaptive_kl_beta=true"],
    "ff_ppo_penalty_continuous": ["network=mlp_mvn_continuous"],
    "ff_dpo_continuous": ["env=mountain_car_continuous"],
    "rec_ppo": ["env=identity_game", "network.rnn_cell_type=lstm"],
}


@pytest.mark.parametrize("name", list(PPO_FAMILY))
@pytest.mark.parametrize("overridden", [False, True])
def test_ppo_family_config_trees_mirror_the_jax_package(name, overridden):
    overrides = PPO_FAMILY[name] + ["system.multistep_impl=pallas"] if overridden else []
    _assert_mirrors(f"default/anakin/default_{name}.yaml", overrides)


# The sequence-replay systems: ff_rainbow (network/noisy_dueling) and
# rec_r2d2 (network/rnn), each root as it is and with other groups and options.
SEQUENCE_REPLAY = {
    "ff_rainbow": ["env=identity_game", "system.vmin=0.0", "system.vmax=10.0"],
    "rec_r2d2": ["env=identity_game", "network.rnn_cell_type=mgu", "system.period=2"],
}


@pytest.mark.parametrize("name", list(SEQUENCE_REPLAY))
@pytest.mark.parametrize("overridden", [False, True])
def test_sequence_replay_config_trees_mirror_the_jax_package(name, overridden):
    overrides = SEQUENCE_REPLAY[name] + ["system.multistep_impl=pallas"] if overridden else []
    _assert_mirrors(f"default/anakin/default_{name}.yaml", overrides)
