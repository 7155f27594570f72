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


# The continuous actor-critics, REINFORCE and AWR (A12's first half) and
# MPO and V-MPO (its second half): each root as it is, and with other groups
# and options.
A12 = {
    "ff_ddpg": ["env=mountain_car_continuous", "system.exploration_sigma=0.3"],
    "ff_td3": ["system.policy_frequency=3", "arch.update_batch_size=2"],
    "ff_d4pg": ["system.vmin=-1700.0", "system.vmax=0.0"],
    "ff_sac": ["system.autotune_alpha=false", "system.init_alpha=0.2"],
    "ff_reinforce": ["env=identity_game", "system.multistep_impl=pallas"],
    "ff_reinforce_continuous": ["network=mlp_mvn_continuous"],
    "ff_awr": ["env=identity_game", "system.multistep_impl=pallas"],
    "ff_awr_continuous": ["system.sample_period=2"],
    "ff_mpo": ["env=identity_game", "system.multistep_impl=pallas", "system.num_samples=8"],
    "ff_mpo_continuous": ["system.retrace_lambda=0.9", "arch.update_batch_size=2"],
    "ff_vmpo": ["env=identity_game", "system.actor_target_period=10"],
    "ff_vmpo_continuous": ["network=mlp_mpo_continuous", "system.multistep_impl=pallas"],
}


@pytest.mark.parametrize("name", list(A12))
@pytest.mark.parametrize("overridden", [False, True])
def test_a12_config_trees_mirror_the_jax_package(name, overridden):
    _assert_mirrors(f"default/anakin/default_{name}.yaml", A12[name] if overridden else [])


# The search systems (A13's first half): each root as it is, and with other
# groups and options.
SEARCH = {
    "ff_az": ["env=identity_game", "system.search_method=gumbel",
              "system.use_replay_buffer=true"],
    "ff_mz": ["env=identity_game", "system.num_simulations=8", "system.wm_cell_type=gru"],
    "ff_sampled_az": ["system.num_sampled_actions=4", "system.multistep_impl=pallas"],
    "ff_sampled_mz": ["system.max_depth=4", "arch.update_batch_size=2"],
}


@pytest.mark.parametrize("name", list(SEARCH))
@pytest.mark.parametrize("overridden", [False, True])
def test_search_config_trees_mirror_the_jax_package(name, overridden):
    _assert_mirrors(f"default/anakin/default_{name}.yaml", SEARCH[name] if overridden else [])


# The rest of A13: SPO (discrete and continuous) and Disco-RL, each root as it
# is and with other groups and options.
A13_REST = {
    "ff_spo": ["env=identity_game", "system.num_particles=8", "system.ess_threshold=0.3"],
    "ff_spo_continuous": ["system.search_horizon=3", "system.multistep_impl=pallas"],
    "ff_disco103": ["env=identity_game", "system.rule_mode=meta", "system.num_bins=11"],
}


@pytest.mark.parametrize("name", list(A13_REST))
@pytest.mark.parametrize("overridden", [False, True])
def test_spo_and_disco_config_trees_mirror_the_jax_package(name, overridden):
    _assert_mirrors(f"default/anakin/default_{name}.yaml", A13_REST[name] if overridden else [])


# Vision and the rest of classic.py and debug.py (A14's first half): every
# new env and network group on the root that trains on it.
VISION = {
    "breakout_pixel_jax": ("ff_ppo", ["env=breakout_pixel_jax", "network=cnn_atari"]),
    "breakout_jax": ("ff_ppo", ["env=breakout_jax", "network=cnn"]),
    "asterix": ("ff_ppo", ["env=asterix", "network=cnn"]),
    "freeway": ("ff_ppo", ["env=freeway", "network=cnn"]),
    "space_invaders": ("ff_ppo", ["env=space_invaders", "network=visual_resnet"]),
    "catch": ("ff_ppo", ["env=catch", "network=cnn"]),
    "acrobot": ("ff_ppo", ["env=acrobot", "network=mlp_resnet"]),
    "mountain_car": ("ff_ppo", ["env=mountain_car"]),
    "sequence_game": ("rec_ppo", ["env=sequence_game"]),
    "sequence_game_long": ("rec_ppo", ["env=sequence_game_long"]),
    "cnn_dqn": ("ff_dqn", ["env=breakout_jax", "network=cnn_dqn"]),
    "cnn_c51": ("ff_c51", ["env=breakout_jax", "network=cnn_c51"]),
}


@pytest.mark.parametrize("group", list(VISION))
def test_vision_config_trees_mirror_the_jax_package(group):
    name, overrides = VISION[group]
    _assert_mirrors(f"default/anakin/default_{name}.yaml", overrides)


# The first-party grid games and locomotion (A14b's first part): every new env
# tree on the roots that train on it on the card.
LOCO_GRID = {
    "ant": ("ff_ppo_continuous", ["env=ant", "system.normalize_observations=true",
                                  "system.multistep_impl=pallas"]),
    "hopper": ("ff_ppo_continuous", ["env=hopper"]),
    "walker2d": ("ff_ppo_continuous", ["env=walker2d"]),
    "halfcheetah": ("ff_ppo_continuous", ["env=halfcheetah"]),
    "ant_sac": ("ff_sac", ["env=ant"]),
    "snake_dqn": ("ff_dqn", ["env=snake"]),
    "snake_c51": ("ff_c51", ["env=snake"]),
    "snake_cnn_dqn": ("ff_dqn", ["env=snake", "network=cnn_dqn",
                                 "env.wrapper.flatten_observation=false"]),
    "snake_ppo": ("ff_ppo", ["env=snake", "system.multistep_impl=pallas"]),
    "game_2048": ("ff_ppo", ["env=game_2048"]),
    "doorkey": ("ff_ppo", ["env=doorkey"]),
}


@pytest.mark.parametrize("case", list(LOCO_GRID))
def test_loco_grid_config_trees_mirror_the_jax_package(case):
    name, overrides = LOCO_GRID[case]
    _assert_mirrors(f"default/anakin/default_{name}.yaml", overrides)


# Sebulba: the three on-policy roots and ff_dqn, each as it is and with the
# native pool's envs (env=breakout, env=breakout_pixel with cnn_atari,
# Pendulum on the pool with the continuous head), IMPACT on, or prioritized
# replay.
SEBULBA = {
    "ff_ppo": ["env=breakout_pixel", "network=cnn_atari", "arch.learner.device_ids=[0]",
               "system.impact.enabled=true"],
    "ff_impala": ["env=breakout", "system.multistep_impl=pallas"],
    "ff_impala_shared_torso": ["env=pendulum", "env.backend=cvec", "network=mlp_continuous"],
    "ff_dqn": ["env=identity_game", "system.replay.prioritized=true",
               "arch.learner.device_ids=[0]"],
}


@pytest.mark.parametrize("name", list(SEBULBA))
@pytest.mark.parametrize("overridden", [False, True])
def test_sebulba_config_trees_mirror_the_jax_package(name, overridden):
    _assert_mirrors(f"default/sebulba/default_{name}.yaml", SEBULBA[name] if overridden else [])


# The population root and its arch group (arch/population.yaml), as they are
# and with the overrides a population run takes.
@pytest.mark.parametrize("overrides", [
    [], ["env=identity_game", "arch.population.size=8", "arch.population.pbt.enabled=true",
         "system.multistep_impl=pallas"]])
def test_population_config_tree_mirrors_the_jax_package(overrides):
    _assert_mirrors("default/population/default_ff_ppo.yaml", overrides)
