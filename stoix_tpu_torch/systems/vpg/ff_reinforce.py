"""Anakin REINFORCE with a critic baseline (counterpart of
stoix_tpu/systems/vpg/ff_reinforce.py), the learner of ff_reinforce and
ff_reinforce_continuous (the continuous head comes from the network config).

One update step, in the JAX package's order (ff_reinforce.py:34-126):

  1. rollout: `rollout_length` steps of every env, each replica's action
     drawn from its generator, storing obs, action, log-prob, reward,
     discount, truncation (the last step of an episode not terminated),
     next_obs and the episode info;
  2. the critic's values of obs (v_tm1) and of next_obs (v_t), no gradient;
  3. the truncation-aware discounted returns G as the targets of GAE at
     lambda = 1 over reward and gamma . discount: ONE launch of B1's GAE
     entry point over the whole [T, U.E] trajectory under
     `system.multistep_impl: pallas`;
  4. one clip + Adam step of the actor on -mean(log pi(a|s) (G - v_tm1)) -
     `ent_coef` . entropy and one of the critic on 0.5 mean((V(s) - G)^2),
     over the replica's whole [T, E] batch, both gradients averaged over
     the replicas, then the data ranks, in one all-reduce.

`arch.update_batch_size` U > 1 runs U replicas as ff_ppo does: params and
optimizer states [U, ...], one generator and one group of envs a replica.
The JAX ff_reinforce does not read `system.update_guard`; the port refuses
it (ROADMAP C18).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple, Union

import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import (
    ActorCriticOptStates, ActorCriticParams, ExperimentOutput, OnPolicyLearnerState,
)
from stoix_tpu_torch.evaluator import get_distribution_act_fn
from stoix_tpu_torch.ops import truncated_generalized_advantage_estimation
from stoix_tpu_torch.systems import anakin, off_policy_core as core
from stoix_tpu_torch.systems.ddpg.ff_ddpg import join_metrics, refuse_ignored_knobs
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import _cat
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam, apply_updates, make_learning_rate
from stoix_tpu_torch.utils.tree import tree_stack


class ReinforceLearner:
    """`learner(state) -> ExperimentOutput` runs `arch.num_updates_per_eval`
    update steps; `rollout` and `update` are the two halves of one step."""

    def __init__(self, env: envs.Environment, apply_fns: Tuple[Callable, Callable],
                 optims: Tuple[ClipAdam, ClipAdam], config: Any):
        self.env = env
        self.actor_apply, self.critic_apply = apply_fns
        self.actor_optim, self.critic_optim = optims
        self.gamma = float(config.system.gamma)
        self.ent_coef = float(config.system.get("ent_coef", 0.0))
        self.multistep_impl = str(config.system.get("multistep_impl", "scan"))
        self.rollout_length = int(config.system.rollout_length)
        self.num_updates_per_eval = int(config.arch.num_updates_per_eval)
        self.update_batch = int(config.arch.get("update_batch_size", 1))
        self.data_group = anakin.data_group()

    def group(self, tree: Any, index: int, dim: int) -> Any:
        return anakin.env_group(tree, index, self.update_batch, dim)

    @torch.no_grad()
    def rollout(self, state: OnPolicyLearnerState) -> Tuple[OnPolicyLearnerState, Dict]:
        """`rollout_length` env steps; the steps stacked to [T, E, ...]."""
        params = anakin.split_replicas(state.params, self.update_batch)
        generators = anakin.per_replica(state.generator, self.update_batch)
        env_state, timestep = state.env_state, state.timestep
        steps = []
        for _ in range(self.rollout_length):
            observation = timestep.observation
            actions, log_probs = [], []
            for u, (p, generator) in enumerate(zip(params, generators)):
                dist = self.actor_apply(p.actor_params, self.group(observation, u, 0))
                action = dist.sample(generator)
                actions.append(action)
                log_probs.append(dist.log_prob(action))
            action = _cat(actions, 0)
            env_state, timestep = self.env.step(env_state, action)
            steps.append({
                "obs": observation,
                "action": action,
                "log_prob": _cat(log_probs, 0),
                "reward": timestep.reward,
                "discount": timestep.discount,
                "truncated": timestep.last() & (timestep.discount != 0.0),
                "next_obs": timestep.extras["next_obs"],
                "info": timestep.extras["episode_metrics"],
            })
        return state._replace(env_state=env_state, timestep=timestep), tree_stack(steps)

    def returns(self, params: List[ActorCriticParams], traj: Dict
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(v_tm1, G) over [T, U.E]: the critic's values, each replica's on
        its envs, and the lambda = 1 targets of one GAE call."""
        with torch.no_grad():
            v_tm1 = _cat([self.critic_apply(p.critic_params, self.group(traj["obs"], u, 1))
                          for u, p in enumerate(params)], 1)
            v_t = _cat([self.critic_apply(p.critic_params, self.group(traj["next_obs"], u, 1))
                        for u, p in enumerate(params)], 1)
            _, targets = truncated_generalized_advantage_estimation(
                traj["reward"], self.gamma * traj["discount"], 1.0, v_tm1=v_tm1, v_t=v_t,
                truncation_t=traj["truncated"].to(torch.float32), impl=self.multistep_impl)
        return v_tm1, targets

    def actor_loss(self, actor_params, obs, action, advantages):
        dist = self.actor_apply(actor_params, obs)
        loss = -torch.mean(dist.log_prob(action) * advantages)
        entropy = dist.entropy().mean()
        return loss - self.ent_coef * entropy, {"actor_loss": loss, "entropy": entropy}

    def critic_loss(self, critic_params, obs, targets):
        loss = 0.5 * torch.mean((self.critic_apply(critic_params, obs) - targets) ** 2)
        return loss, {"value_loss": loss}

    def update(self, params: Any, opt_states: Any, traj: Dict
               ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
        """Returns, then one actor and one critic step of every replica on
        its [T, E] batch."""
        replica_params = anakin.split_replicas(params, self.update_batch)
        replica_opts = anakin.split_replicas(opt_states, self.update_batch)
        v_tm1, targets = self.returns(replica_params, traj)
        advantages = targets - v_tm1
        actor_grads, critic_grads, metrics = [], [], []
        for u, p in enumerate(replica_params):
            obs, action, adv, g_t = (self.group(x, u, 1) for x in (
                traj["obs"], traj["action"], advantages, targets))
            a_grads, a_metrics = core.value_and_grad(self.actor_loss, p.actor_params, obs,
                                                     action, adv)
            c_grads, c_metrics = core.value_and_grad(self.critic_loss, p.critic_params, obs, g_t)
            actor_grads.append(a_grads)
            critic_grads.append(c_grads)
            metrics.append({**a_metrics, **c_metrics})
        actor_grads, critic_grads = anakin.data_mean(
            (anakin.mean_gradients(actor_grads), anakin.mean_gradients(critic_grads)),
            self.data_group)
        new_params, new_opts = [], []
        for p, opt in zip(replica_params, replica_opts):
            a_updates, a_opt = self.actor_optim.update(actor_grads, opt.actor_opt_state)
            c_updates, c_opt = self.critic_optim.update(critic_grads, opt.critic_opt_state)
            new_params.append(ActorCriticParams(apply_updates(p.actor_params, a_updates),
                                                apply_updates(p.critic_params, c_updates)))
            new_opts.append(ActorCriticOptStates(a_opt, c_opt))
        return (anakin.join_replicas(new_params), anakin.join_replicas(new_opts),
                join_metrics(metrics))

    def update_step(self, state: OnPolicyLearnerState) -> Tuple[OnPolicyLearnerState, Tuple]:
        state, traj = self.rollout(state)
        params, opt_states, metrics = self.update(state.params, state.opt_states, traj)
        return state._replace(params=params, opt_states=opt_states), (traj["info"], metrics)

    def __call__(self, state: OnPolicyLearnerState) -> ExperimentOutput:
        episode_info, loss_info = [], []
        for _ in range(self.num_updates_per_eval):
            state, (episodes, losses_) = self.update_step(state)
            episode_info.append(episodes)
            loss_info.append(losses_)
        return ExperimentOutput(state, tree_stack(episode_info), anakin.data_mean(
            tree_stack(loss_info), self.data_group, kind="metrics"))


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    """The actor and critic (initialised on the CPU from `seed`, then moved
    to `device`), their clip + Adam, the learner and its initial state."""
    refuse_ignored_knobs(config, str(config.system.system_name))
    config.system.action_dim = env.num_actions
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)
    actor, critic = ff_ppo.build_networks(env, config,
                                          anakin.make_generator(init_seed, torch.device("cpu")))
    actor.to(device)
    critic.to(device)
    apply_fns = (ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic))
    max_grad_norm = float(config.system.max_grad_norm)
    optims = tuple(ClipAdam(make_learning_rate(float(config.system[key]), config),
                            max_grad_norm, eps=1e-5) for key in ("actor_lr", "critic_lr"))
    params, opt_states, generator = ff_ppo.initial_train_state(
        actor, critic, optims, config, device, step_seed)
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    update_batch = int(config.arch.get("update_batch_size", 1))
    return AnakinSetup(
        learn=ReinforceLearner(env, apply_fns, optims, config),
        learner_state=OnPolicyLearnerState(params, opt_states, generator, env_state, timestep),
        eval_act_fn=get_distribution_act_fn(config, apply_fns[0]),
        eval_params_fn=lambda s: anakin.split_replicas(s.params, update_batch)[0].actor_params,
    )


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin REINFORCE; returns the final evaluation episode-return
    mean. Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_reinforce.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
