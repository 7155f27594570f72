"""Anakin AWR, advantage-weighted regression (counterpart of
stoix_tpu/systems/awr/ff_awr.py), the learner of ff_awr and
ff_awr_continuous (the continuous head comes from the network config).

On the learner of systems/off_policy_core.py, with no warm-up:

  - acting samples the actor's distribution from the replica's generator;
    each step stores obs, action (int32, or float32 for a continuous
    head), reward and discount, added as [E_u, T] trajectories (no episode
    info) to the replica's trajectory buffer (`trajectory_buffer_sizing`
    with at least 2 x `rollout_length` slots, sequences of
    `sample_sequence_length` at `sample_period`);
  - each epoch samples [B, L] sequences a replica, takes the critic's
    values V [B, L] and the TD(lambda) returns
    `lambda_returns(r[:, :-1], gamma . discount[:, :-1], V[:, 1:], lambda,
    batch_major=True)`, every replica's batch in ONE call (one launch of B1's
    generic entry point under `system.multistep_impl: pallas`, fed the
    batch-major view made contiguous once; `system.multistep_impl` picks the
    route, as ff_ppo's learner reads it), all of it without gradient (the
    JAX package stops it: both are constants of the losses);
  - the actor's loss -mean(min(exp(A / beta), weight_clip) log pi(a|s)) with
    A = G - V, the critic's 0.5 mean((V(s) - G)^2), over the first L - 1
    steps; one clip + Adam step each, both gradients averaged over the
    replicas, then the data ranks, in one all-reduce.

The JAX ff_awr does not read `system.update_guard`; the port refuses it
(ROADMAP C18).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple, Union

import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import (
    ActorCriticOptStates, ActorCriticParams, OffPolicyLearnerState,
)
from stoix_tpu_torch.buffers import make_trajectory_buffer
from stoix_tpu_torch.envs import spaces
from stoix_tpu_torch.evaluator import get_distribution_act_fn
from stoix_tpu_torch.ops.multistep import lambda_returns
from stoix_tpu_torch.systems import anakin, off_policy_core as core
from stoix_tpu_torch.systems.ddpg.ff_ddpg import join_metrics, refuse_ignored_knobs
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import _cat
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam, apply_updates, make_learning_rate
from stoix_tpu_torch.utils.tree import tree_map


def store_step(last_timestep: Any, action: torch.Tensor, timestep: Any) -> dict:
    """What the buffer keeps of one step (and its episode info, not stored)."""
    return {
        "obs": last_timestep.observation,
        "action": action,
        "reward": timestep.reward,
        "discount": timestep.discount,
        "info": timestep.extras["episode_metrics"],
    }


def dummy_item(env: envs.Environment, discrete: bool, device: Any) -> dict:
    return {
        "obs": tree_map(lambda x: x.to(device), env.observation_value()),
        "action": torch.as_tensor(env.action_value(),
                                  dtype=torch.int32 if discrete else torch.float32).to(device),
        "reward": torch.zeros((), dtype=torch.float32, device=device),
        "discount": torch.zeros((), dtype=torch.float32, device=device),
    }


def _leading(tree: Any, stop: int) -> Any:
    return tree_map(lambda x: x[:, :stop], tree)


class AWRUpdate:
    """`update_from_batch` of AWR over lists of one [B, L] sequence batch a
    replica: returns once for every replica, then each replica's actor and
    critic losses, the gradients averaged, and each replica's two steps."""

    def __init__(self, actor_apply: Callable, critic_apply: Callable,
                 optims: Tuple[ClipAdam, ClipAdam], config: Any):
        self.actor_apply, self.critic_apply = actor_apply, critic_apply
        self.actor_optim, self.critic_optim = optims
        self.gamma = float(config.system.gamma)
        self.lam = float(config.system.get("gae_lambda", 0.95))
        self.beta = float(config.system.get("awr_beta", 0.05))
        self.w_max = float(config.system.get("weight_clip", 20.0))
        self.multistep_impl = str(config.system.get("multistep_impl", "scan"))
        self.data_group = anakin.data_group()

    def returns(self, params: List[ActorCriticParams], batches: List[Dict]
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each replica's (advantages, returns) [B, L - 1], the returns of
        every replica from one `lambda_returns` call over [U.B, L - 1]."""
        with torch.no_grad():
            values = [self.critic_apply(p.critic_params, b["obs"]) for p, b in zip(params, batches)]
            reward, discount = (_cat([b[k] for b in batches], 0) for k in ("reward", "discount"))
            value = _cat(values, 0)
            returns = lambda_returns(reward[:, :-1], self.gamma * discount[:, :-1], value[:, 1:],
                                     self.lam, batch_major=True, impl=self.multistep_impl)
            parts = returns.split([b["reward"].shape[0] for b in batches])
        return [(g - v[:, :-1], g) for g, v in zip(parts, values)]

    def actor_loss(self, actor_params, batch: Dict, advantages: torch.Tensor):
        dist = self.actor_apply(actor_params, _leading(batch["obs"], -1))
        log_prob = dist.log_prob(batch["action"][:, :-1])
        weights = torch.clamp(torch.exp(advantages / self.beta), max=self.w_max)
        loss = -torch.mean(weights * log_prob)
        return loss, {"actor_loss": loss, "mean_weight": torch.mean(weights)}

    def critic_loss(self, critic_params, batch: Dict, returns: torch.Tensor):
        value = self.critic_apply(critic_params, _leading(batch["obs"], -1))
        loss = 0.5 * torch.mean((value - returns) ** 2)
        return loss, {"value_loss": loss}

    def __call__(self, params: List[ActorCriticParams], opt_states: List[ActorCriticOptStates],
                 batches: List[Dict]):
        actor_grads, critic_grads, metrics = [], [], []
        for p, batch, (adv, g) in zip(params, batches, self.returns(params, batches)):
            a_grads, a_metrics = core.value_and_grad(self.actor_loss, p.actor_params, batch, adv)
            c_grads, c_metrics = core.value_and_grad(self.critic_loss, p.critic_params, batch, g)
            actor_grads.append(a_grads)
            critic_grads.append(c_grads)
            metrics.append({**a_metrics, **c_metrics})
        actor_grads, critic_grads = anakin.data_mean(
            (anakin.mean_gradients(actor_grads), anakin.mean_gradients(critic_grads)),
            self.data_group)
        new_params, new_opts = [], []
        for p, opt in zip(params, opt_states):
            a_updates, a_opt = self.actor_optim.update(actor_grads, opt.actor_opt_state)
            c_updates, c_opt = self.critic_optim.update(critic_grads, opt.critic_opt_state)
            new_params.append(ActorCriticParams(apply_updates(p.actor_params, a_updates),
                                                apply_updates(p.critic_params, c_updates)))
            new_opts.append(ActorCriticOptStates(a_opt, c_opt))
        return new_params, new_opts, join_metrics(metrics)


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    """The actor and critic (initialised on the CPU from `seed`, then moved
    to `device`), their clip + Adam, one trajectory buffer a replica, the
    learner and its initial state."""
    refuse_ignored_knobs(config, str(config.system.system_name))
    config.system.action_dim = env.num_actions
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)
    update_batch = int(config.arch.get("update_batch_size", 1))
    actor, critic = ff_ppo.build_networks(env, config,
                                          anakin.make_generator(init_seed, torch.device("cpu")))
    actor.to(device)
    critic.to(device)
    actor_apply, critic_apply = ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic)
    epochs, max_grad_norm = int(config.system.epochs), float(config.system.max_grad_norm)
    optims = tuple(ClipAdam(make_learning_rate(float(config.system[key]), config, epochs),
                            max_grad_norm, eps=1e-5) for key in ("actor_lr", "critic_lr"))
    params, opt_states, generator = ff_ppo.initial_train_state(
        actor, critic, optims, config, device, step_seed)

    local_envs, sample_batch, max_length = core.trajectory_buffer_sizing(
        config, 2 * int(config.system.rollout_length))
    buffer = make_trajectory_buffer(
        add_batch_size=local_envs,
        sample_batch_size=sample_batch,
        sample_sequence_length=int(config.system.get("sample_sequence_length", 8)),
        period=int(config.system.get("sample_period", 1)),
        max_length_time_axis=max_length,
    )
    discrete = not isinstance(env.action_space(), spaces.Box)

    def act_in_env(params: ActorCriticParams, observation: Any, generator: torch.Generator,
                   buffer_state: Any = None) -> torch.Tensor:
        return actor_apply(params.actor_params, observation).sample(generator)

    learner = core.OffPolicyLearner(env, buffer, config,
                                    AWRUpdate(actor_apply, critic_apply, optims, config),
                                    act_in_env, store=store_step)
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    learner_state = OffPolicyLearnerState(
        params=params,
        opt_states=opt_states,
        buffer_state=anakin.join_per_replica(
            [buffer.init(dummy_item(env, discrete, device)) for _ in range(update_batch)]),
        generator=generator,
        env_state=env_state,
        timestep=timestep,
    )
    return AnakinSetup(
        learn=learner,
        learner_state=learner_state,
        eval_act_fn=get_distribution_act_fn(config, actor_apply),
        eval_params_fn=lambda s: anakin.split_replicas(s.params, update_batch)[0].actor_params,
    )


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin AWR; returns the final evaluation episode-return mean.
    Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_awr.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
