"""Anakin TD3 (counterpart of stoix_tpu/systems/ddpg/ff_td3.py): ff_ddpg's
learner with twin critics (`num_critics=2`) and a min backup, target-policy
smoothing, and a delayed actor step (ff_td3.py:72-125):

  - the target action is mu_target(s') + clip(normal . 0.2, -0.5, 0.5),
    clipped to [lo, hi], the normal drawn from the replica's generator;
  - the target is r + gamma (1 - done) min over the twins of Q_target;
  - the actor steps only where `count % policy_frequency == 0`. The JAX
    system computes the step every time and keeps the old actor params and
    the old actor optimizer state (Adam's count included) through
    `jnp.where`; here `count` is a host int, the same on every rank and
    replica, so an off step skips the actor's backward and Adam and keeps
    both bitwise, computing only the actor loss's forward for its metric;
  - both targets are Polyak-updated on every step, the actor's from the
    (possibly unchanged) online actor.

`count` is carried in the optimizer states beside DDPG's, as the JAX
package carries it (ff_td3.py:57), so a checkpoint resumes it.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Union

import torch

from stoix_tpu_torch.base_types import OnlineAndTarget, Transition
from stoix_tpu_torch.systems.ddpg import ff_ddpg
from stoix_tpu_torch.systems.ddpg.ff_ddpg import DDPGOptStates, DDPGParams
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import incremental_update


class TD3OptStates(NamedTuple):
    opt_states: DDPGOptStates
    count: int  # update steps taken (a host int; the JAX package's int32 scalar)


class TD3Update(ff_ddpg.DDPGUpdate):
    """DDPG's update with target smoothing, the twins' min and the delayed
    actor step; `draw_noise` draws the smoothing normals [B, A]."""

    def __init__(self, actor_apply, q_apply, optims, config, bounds):
        super().__init__(actor_apply, q_apply, optims, config, bounds)
        self.smoothing_sigma = float(config.system.get("target_policy_noise", 0.2))
        self.noise_clip = float(config.system.get("target_noise_clip", 0.5))
        self.policy_frequency = int(config.system.get("policy_frequency", 2))

    @staticmethod
    def initial_opt_states(opt_states: DDPGOptStates) -> TD3OptStates:
        return TD3OptStates(opt_states, 0)

    def draw_noise(self, batch: Transition, generator: Optional[torch.Generator]) -> torch.Tensor:
        shape = (batch.reward.shape[0],) + tuple(batch.action.shape[1:])
        return torch.randn(shape, generator=generator, device=batch.reward.device)

    def targets(self, params: DDPGParams, batch: Transition, noise: torch.Tensor
                ) -> torch.Tensor:
        lo, hi = self.bounds
        next_action = self.actor_apply(params.actor_params.target, batch.next_obs).mode()
        noise = torch.clamp(noise * self.smoothing_sigma, -self.noise_clip, self.noise_clip)
        next_action = torch.clamp(next_action + noise, lo, hi)
        q_next = torch.amin(self.q_apply(params.q_params.target, batch.next_obs, next_action),
                            dim=-1)
        return batch.reward + ff_ddpg.discounts(batch, self.gamma) * q_next

    def step(self, params: List[DDPGParams], opt_states: List[TD3OptStates],
             batches: List[Transition], noises: Sequence[Any]):
        count = opt_states[0].count
        inner = [o.opt_states for o in opt_states]
        q_params, q_opts, q_metrics = self.critic_step(params, inner, batches, noises)
        actors = [p.actor_params for p in params]
        actor_opts = [o.actor_opt_state for o in inner]
        if count % self.policy_frequency == 0:
            stepped, actor_opts, actor_metrics = self.actor_step(
                actors, actor_opts, [q.online for q in q_params], batches)
            actors = stepped
        else:
            with torch.no_grad():
                actor_metrics = [self.actor_loss(a.online, q.online, b.obs)[1]
                                 for a, q, b in zip(actors, q_params, batches)]
            actors = [OnlineAndTarget(a.online, incremental_update(a.online, a.target, self.tau))
                      for a in actors]
        new_params = [DDPGParams(a, q) for a, q in zip(actors, q_params)]
        new_opts = [TD3OptStates(DDPGOptStates(a, q), count + 1)
                    for a, q in zip(actor_opts, q_opts)]
        return new_params, new_opts, ff_ddpg.join_metrics(
            [{**q, **a} for q, a in zip(q_metrics, actor_metrics)])


def build_networks(env, config: Any, generator: torch.Generator):
    """ff_ddpg's networks with twin critics."""
    return ff_ddpg.build_networks(env, config, generator, num_critics=2)


def learner_setup(env, config: Any, device: torch.device, seed: int):
    return ff_ddpg.learner_setup(env, config, device, seed, build_networks, TD3Update, "ff_td3")


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    return ff_ddpg.run_off_policy_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_td3.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
