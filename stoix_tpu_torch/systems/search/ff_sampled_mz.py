"""Anakin Sampled MuZero (counterpart of
stoix_tpu/systems/search/ff_sampled_mz.py): continuous-action MuZero, the
sampled action set of ff_sampled_az.py searched in ff_mz.py's learned model.

The world model embeds a continuous action with an MLP of
`wm_hidden_size // 2`; the latent policy is a tanh-Gaussian on the action
space's smallest low and largest high. Acting draws the root's K actions
from the policy at the observation's latent, blended toward uniform noise
on the bounds, and a fresh set at every expanded latent (the per-node
normals [S, E, K, A] from the replica's generator); each step also stores
the model's value of the true successor's latent.

The epoch is ff_mz.py's unroll with two changes (ff_sampled_mz.py:162-237):
the value targets fold gamma . V(true successor) into the reward of a
truncated step (then cut the n-step chain there, so truncated boundaries
still bootstrap), and the policy loss is the weighted log-likelihood of the
STORED sampled set, -sum_i w_i log pi(a_i | latent), masked past the
episode's end.

The JAX ff_sampled_mz reads neither `system.update_guard` nor
`system.unroll_steps`; the port refuses both set (ROADMAP C20).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.search import mcts
from stoix_tpu_torch.systems.ddpg.ff_ddpg import action_bounds
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.systems.search.ff_az import _truncated, refuse_ignored_knobs, scalars
from stoix_tpu_torch.systems.search.ff_mz import (
    MZ_IGNORED, MuZeroNetworks, MuZeroUpdate, MZParams, build_networks, muzero_setup,
)
from stoix_tpu_torch.systems.search.ff_sampled_az import (
    SampledNoise, SampledSearch, sampled_log_probs,
)
from stoix_tpu_torch.utils import config as config_lib


class SampledMZActing(SampledSearch):
    """ff_sampled_mz's acting (ff_sampled_mz.py:71-160)."""

    def __init__(self, nets: MuZeroNetworks, env: envs.Environment, config: Any):
        super().__init__(env, config)
        self.nets = nets

    def recurrent_fn(self, params: MZParams, normals: torch.Tensor, action_idx: torch.Tensor,
                     embedding: Dict):
        latent, actions = embedding["latent"], embedding["actions"]
        rows = torch.arange(actions.shape[0], device=actions.device)
        new_latent, reward_logits = self.nets.wm(params.world_model, "step", latent,
                                                 actions[rows, action_idx])
        reward = self.nets.pair.apply_inv(reward_logits)
        # Per-node resampling from the policy at the NEW latent.
        dist = self.nets.policy(params.policy_head, new_latent)
        out = mcts.RecurrentFnOutput(
            reward=reward, discount=torch.full_like(reward, self.gamma),
            prior_logits=reward.new_zeros(reward.shape + (self.num_samples,)),
            value=self.nets.value(params, new_latent))
        return out, {"latent": new_latent, "actions": self.node_actions(dist, normals)}

    def act(self, params: MZParams, noise: SampledNoise, sim_state: Any, observation: Any):
        latent = self.nets.latent(params, observation.agent_view)
        sampled = self.root_actions(self.nets.policy(params.policy_head, latent), noise)
        action, out = self.run(params, noise, self.nets.value(params, latent),
                               {"latent": latent, "actions": sampled}, self.recurrent_fn)
        return action, {"sampled_actions": sampled, "search_policy": out.action_weights,
                        "search_value": out.search_value}

    def record(self, params, last_timestep, action, timestep, extras):
        # The model's value of the TRUE successor, for truncated steps: the
        # n-step targets bootstrap through the step-limit boundary.
        boot = self.nets.latent(params, timestep.extras["next_obs"].agent_view)
        return {
            "obs": last_timestep.observation.agent_view,
            "action": action,
            **extras,
            "bootstrap_value": self.nets.value(params, boot),
            "reward": timestep.reward,
            "done": (timestep.discount == 0.0).to(torch.float32),
            "truncated": _truncated(timestep),
            "info": timestep.extras["episode_metrics"],
        }


class SampledMZUpdate(MuZeroUpdate):
    """ff_mz's update with the sampled set's policy loss and the truncation
    bootstrap folded into the value targets' rewards."""

    def value_rewards(self, seq: Dict, r_t: torch.Tensor, truncated: torch.Tensor
                      ) -> torch.Tensor:
        return r_t + self.gamma * truncated * seq["bootstrap_value"][:, :-1]

    def policy_terms(self, params: MZParams, latent: torch.Tensor, seq: Dict, t: int,
                     mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dist = self.nets.policy(params.policy_head, latent)
        log_probs = sampled_log_probs(dist, seq["sampled_actions"][:, t])
        ce = -torch.sum(seq["search_policy"][:, t] * log_probs, dim=-1)
        return torch.mean(ce * mask), torch.mean(dist.entropy() * mask)


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    from stoix_tpu_torch.networks.heads import NormalAffineTanhDistributionHead
    from stoix_tpu_torch.networks.torso import MLPTorso

    refuse_ignored_knobs(config, "ff_sampled_mz", MZ_IGNORED)
    config.system.action_dim = env.num_actions
    action_dim = env.num_actions
    lo, hi = action_bounds(env)
    hidden = int(config.system.get("wm_hidden_size", 64))
    num_samples = int(config.system.get("num_sampled_actions", 8))

    def nets_fn(generator: torch.Generator) -> MuZeroNetworks:
        return build_networks(
            env, config, generator, MLPTorso(action_dim, (hidden // 2,), generator=generator),
            lambda width: NormalAffineTanhDistributionHead(action_dim, width, minimum=lo,
                                                           maximum=hi, generator=generator))

    def item(device: torch.device) -> Dict:
        return {"obs": env.observation_value().agent_view.to(device),
                "action": torch.zeros((action_dim,), device=device),
                "sampled_actions": torch.zeros((num_samples, action_dim), device=device),
                "search_policy": torch.zeros((num_samples,), device=device),
                **scalars(device, "search_value", "bootstrap_value", "reward", "done",
                          "truncated")}

    return muzero_setup(env, config, device, seed, nets_fn,
                        lambda nets, env_, cfg: SampledMZActing(nets, env_, cfg),
                        SampledMZUpdate, item)


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin Sampled MuZero; returns the final evaluation
    episode-return mean. Runs on CUDA unless the caller asks for another
    device."""
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_sampled_mz.yaml",
        sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
