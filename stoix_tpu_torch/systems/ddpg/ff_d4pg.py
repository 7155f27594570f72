"""Anakin D4PG (counterpart of stoix_tpu/systems/ddpg/ff_d4pg.py): ff_ddpg's
learner with a distributional critic, one FeedForwardCritic whose head is
`DistributionalContinuousQNetwork` (`system.num_atoms` atoms on [vmin, vmax],
51 on [-100, 100] by default). Its update (ff_d4pg.py:98-132):

  - the target distribution: the atoms shifted to r + gamma (1 - done) z,
    projected (`categorical_l2_project`, ROADMAP C16's) onto the support
    from softmax of the target critic's logits at (s', mu_target(s'));
  - the critic's loss: its cross-entropy against log-softmax of the online
    logits at (s, a);
  - the actor maximises the expected Q of the updated online critic.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from stoix_tpu_torch.base_types import Transition
from stoix_tpu_torch.ops.losses import categorical_l2_project
from stoix_tpu_torch.systems.ddpg import ff_ddpg
from stoix_tpu_torch.systems.ddpg.ff_ddpg import DDPGParams
from stoix_tpu_torch.utils import config as config_lib


def build_networks(env, config: Any, generator: torch.Generator):
    """(actor, critic, (lo, hi)): the deterministic actor and one
    distributional Q(s, a) critic."""
    lo, hi = ff_ddpg.action_bounds(env)
    actor = ff_ddpg.build_actor(env, config, generator, minimum=lo, maximum=hi)
    critic = ff_ddpg.build_critic(
        env, config, generator, num_atoms=int(config.system.get("num_atoms", 51)),
        vmin=float(config.system.get("vmin", -100.0)), vmax=float(config.system.get("vmax", 100.0)))
    return actor, critic, (lo, hi)


class D4PGUpdate(ff_ddpg.DDPGUpdate):
    """DDPG's update with the categorical critic: `targets` are the
    projected target probabilities [B, M]."""

    def targets(self, params: DDPGParams, batch: Transition, noise: Any) -> torch.Tensor:
        next_action = self.actor_apply(params.actor_params.target, batch.next_obs).mode()
        _, next_logits, atoms = self.q_apply(params.q_params.target, batch.next_obs, next_action)
        d_t = ff_ddpg.discounts(batch, self.gamma)
        target_z = batch.reward[:, None] + d_t[:, None] * atoms[None, :]
        return categorical_l2_project(target_z, torch.softmax(next_logits, dim=-1), atoms)

    def q_loss(self, q_online: Dict[str, torch.Tensor], batch: Transition,
               target_probs: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        _, logits, _ = self.q_apply(q_online, batch.obs, batch.action)
        loss = torch.mean(-torch.sum(target_probs * torch.log_softmax(logits, dim=-1), dim=-1))
        return loss, {"q_loss": loss}

    def actor_loss(self, actor_online, q_online, obs):
        action = self.actor_apply(actor_online, obs).mode()
        q_value, _, _ = self.q_apply(q_online, obs, action)
        loss = -torch.mean(q_value)
        return loss, {"actor_loss": loss}


def learner_setup(env, config: Any, device: torch.device, seed: int):
    """As ff_ddpg's, with the distributional critic; returns (setup, warmup)."""
    return ff_ddpg.learner_setup(env, config, device, seed, build_networks, D4PGUpdate, "ff_d4pg")


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    return ff_ddpg.run_off_policy_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_d4pg.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
