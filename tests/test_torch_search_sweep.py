"""The search systems of the PyTorch port (stoix_tpu_torch/systems/search)
end to end on the CPU through `run_experiment`, at the JAX sweep's budget
(tests/test_systems_sweep.py: 16 envs, T = 8, 2 048 steps, 8 simulations,
4 sampled actions) with `system.multistep_impl=pallas`: a finite return and
B1's GAE calls (on the card each one launch): one an ff_az update, one an
epoch in replay mode and on ff_sampled_az, none on the MuZero family; the
sampled systems at MLPs of 16 x 16 and a world model of 16 with 4 epochs (at
their defaults' 256-wide MLPs and 64 or 32 epochs the CPU takes minutes).
"""

import numpy as np
import pytest

from stoix_tpu_torch.systems.search import ff_az, ff_mz, ff_sampled_az, ff_sampled_mz
from stoix_tpu_torch.utils import config as config_lib
from test_torch_continuous import _count_b1_calls
import torch_parity  # noqa: F401  (one intra-op thread, as every port test)

SWEEP = ["arch.total_num_envs=16", "arch.total_timesteps=2048", "arch.num_evaluation=1",
         "arch.num_eval_episodes=8", "arch.absolute_metric=False", "system.rollout_length=8",
         "logger.use_console=False", "system.multistep_impl=pallas",
         "system.num_simulations=8"]
SAMPLED = ["network.actor_network.pre_torso.layer_sizes=[16,16]",
           "network.critic_network.pre_torso.layer_sizes=[16,16]", "system.wm_hidden_size=16",
           "system.num_sampled_actions=4", "system.epochs=4"]
UPDATES = 2048 // (16 * 8)
RUNS = {
    "ff_az": (ff_az, ["env=identity_game", "system.num_minibatches=2"], UPDATES),
    "ff_az_replay": (ff_az, ["env=identity_game", "system.use_replay_buffer=true",
                             "system.total_buffer_size=4096", "system.total_batch_size=32"],
                     UPDATES * 4),
    "ff_mz": (ff_mz, ["env=identity_game"], 0),
    "ff_sampled_az": (ff_sampled_az, SAMPLED, UPDATES * 4),
    "ff_sampled_mz": (ff_sampled_mz, SAMPLED, 0),
}


def run_path(path, monkeypatch):
    module, extra, gae_calls = RUNS[path]
    system = module.__name__.rsplit(".", 1)[1]
    calls = _count_b1_calls(monkeypatch)
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             f"default/anakin/default_{system}.yaml", SWEEP + extra)
    assert np.isfinite(module.run_experiment(cfg, device="cpu"))
    assert calls == {"gae": gae_calls, "generic": 0}


# The MuZero pair's runs are in tests/test_torch_muzero_sweep.py (each file
# under a minute).
@pytest.mark.parametrize("path", ["ff_az", "ff_az_replay", "ff_sampled_az"])
def test_each_search_path_runs_at_the_sweep_budget_with_its_gae_calls(path, monkeypatch):
    run_path(path, monkeypatch)
