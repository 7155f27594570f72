"""Anakin PPO, discrete actions (counterpart of
stoix_tpu/systems/ppo/anakin/ff_ppo.py on its two-pass, single-replica,
single-device path).

One update step, in the JAX package's order:

  1. rollout: `rollout_length` steps of every env (a Python loop where the
     JAX package scans), storing raw observations, actions, values and
     log-probs;
  2. ONE batched critic pass over the [T, E] `extras["next_obs"]` for the
     bootstrap values;
  3. truncation-aware GAE, whose recurrence runs through the Hopper kernel
     under `system.multistep_impl: pallas`;
  4. `epochs` times: a permutation of the T·E samples, then
     `num_minibatches` clipped-PPO updates, each an actor and a critic
     gradient pass and a global-norm clip + Adam step.

Parameters are `{name: tensor}` dicts applied with
`torch.func.functional_call`; updates build new dicts and never write in
place, so a window's eval params need no copy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.func import functional_call

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import (
    ActorCriticOptStates,
    ActorCriticParams,
    ExperimentOutput,
    PPOTransition,
)
from stoix_tpu_torch.evaluator import get_distribution_act_fn
from stoix_tpu_torch.ops import losses, truncated_generalized_advantage_estimation
from stoix_tpu_torch.systems import anakin
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam, apply_updates, make_learning_rate
from stoix_tpu_torch.utils.tree import tree_map, tree_merge_leading_dims, tree_stack


class PPOLearnerState(NamedTuple):
    params: ActorCriticParams
    opt_states: ActorCriticOptStates
    generator: torch.Generator  # actions and shuffles; the envs carry their own
    env_state: Any
    timestep: envs.TimeStep


class UpdateResult(NamedTuple):
    params: ActorCriticParams
    opt_states: ActorCriticOptStates
    loss_info: Dict[str, torch.Tensor]  # each [epochs, num_minibatches]
    advantages: torch.Tensor  # [T, E]
    targets: torch.Tensor  # [T, E]


def check_ported_system(config: Any) -> None:
    """Raise NotImplementedError, naming the key, for a system setting this
    slice of the port does not implement."""
    system = config.system
    unported = []
    if system.get("normalize_observations", False):
        unported.append("system.normalize_observations=true")
    # YAML reads the default `off` as False.
    if system.get("update_guard", False) not in (False, None, "off"):
        unported.append("system.update_guard != off")
    if system.get("adaptive_kl_beta", False):
        unported.append("system.adaptive_kl_beta")
    if system.get("fused_update", False):
        unported.append("system.fused_update=true")
    if unported:
        raise NotImplementedError("not ported: " + ", ".join(unported))


def _leaf_copies(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


class PPOLearner:
    """The learner function: `learner(state) -> ExperimentOutput` runs
    `arch.num_updates_per_eval` update steps. `rollout` and `update` are the
    two halves of one step, callable on their own."""

    def __init__(
        self,
        env: envs.Environment,
        apply_fns: Tuple[Callable, Callable],
        update_fns: Tuple[ClipAdam, ClipAdam],
        config: Any,
    ):
        check_ported_system(config)
        self.env = env
        self.actor_apply, self.critic_apply = apply_fns
        self.actor_optim, self.critic_optim = update_fns
        system = config.system
        self.gamma = float(system.gamma)
        self.reward_scale = float(system.get("reward_scale", 1.0))
        self.gae_lambda = float(system.gae_lambda)
        self.clip_eps = float(system.clip_eps)
        self.ent_coef = float(system.ent_coef)
        self.vf_coef = float(system.vf_coef)
        self.clip_value = bool(system.get("clip_value", True))
        self.standardize_advantages = bool(system.get("standardize_advantages", True))
        self.multistep_impl = str(system.get("multistep_impl", "scan"))
        self.rollout_length = int(system.rollout_length)
        self.epochs = int(system.epochs)
        self.num_minibatches = int(system.num_minibatches)
        self.num_updates_per_eval = int(config.arch.num_updates_per_eval)

    @torch.no_grad()
    def rollout(self, state: PPOLearnerState) -> Tuple[PPOLearnerState, PPOTransition]:
        """`rollout_length` env steps; the transitions stacked to [T, E, ...]."""
        params = state.params
        env_state, timestep = state.env_state, state.timestep
        transitions = []
        for _ in range(self.rollout_length):
            observation = timestep.observation
            policy = self.actor_apply(params.actor_params, observation)
            value = self.critic_apply(params.critic_params, observation)
            action = policy.sample(state.generator)
            log_prob = policy.log_prob(action)
            env_state, timestep = self.env.step(env_state, action)
            transitions.append(
                PPOTransition(
                    done=timestep.discount == 0.0,
                    truncated=timestep.last() & (timestep.discount != 0.0),
                    action=action,
                    value=value,
                    reward=timestep.reward,
                    log_prob=log_prob,
                    obs=observation,
                    next_obs=timestep.extras["next_obs"],
                    info=timestep.extras["episode_metrics"],
                )
            )
        state = state._replace(env_state=env_state, timestep=timestep)
        return state, tree_stack(transitions)

    def _update_minibatch(
        self, params: ActorCriticParams, opt_states: ActorCriticOptStates, batch: Tuple
    ) -> Tuple[ActorCriticParams, ActorCriticOptStates, Dict[str, torch.Tensor]]:
        obs, action, old_log_prob, old_value, advantages, targets = batch
        with torch.enable_grad():
            actor_params = _leaf_copies(params.actor_params)
            policy = self.actor_apply(actor_params, obs)
            loss_actor = losses.ppo_clip_loss(
                policy.log_prob(action), old_log_prob, advantages, self.clip_eps
            )
            entropy = policy.entropy().mean()
            actor_total = loss_actor - self.ent_coef * entropy
            actor_grads = dict(
                zip(actor_params, torch.autograd.grad(actor_total, list(actor_params.values())))
            )

            critic_params = _leaf_copies(params.critic_params)
            value = self.critic_apply(critic_params, obs)
            if self.clip_value:
                value_loss = losses.clipped_value_loss(value, old_value, targets, self.clip_eps)
            else:
                value_loss = torch.mean((value - targets) ** 2)
            critic_grads = dict(
                zip(
                    critic_params,
                    torch.autograd.grad(self.vf_coef * value_loss, list(critic_params.values())),
                )
            )

        actor_updates, actor_opt_state = self.actor_optim.update(
            actor_grads, opt_states.actor_opt_state
        )
        critic_updates, critic_opt_state = self.critic_optim.update(
            critic_grads, opt_states.critic_opt_state
        )
        params = ActorCriticParams(
            apply_updates(params.actor_params, actor_updates),
            apply_updates(params.critic_params, critic_updates),
        )
        loss_actor, value_loss, entropy = (x.detach() for x in (loss_actor, value_loss, entropy))
        loss_info = {
            "total_loss": loss_actor + value_loss,
            "actor_loss": loss_actor,
            "value_loss": value_loss,
            "entropy": entropy,
        }
        return params, ActorCriticOptStates(actor_opt_state, critic_opt_state), loss_info

    def update(
        self,
        params: ActorCriticParams,
        opt_states: ActorCriticOptStates,
        traj_batch: PPOTransition,
        generator: Optional[torch.Generator] = None,
        permutations: Optional[Sequence[torch.Tensor]] = None,
    ) -> UpdateResult:
        """Bootstrap values, GAE, then epochs × minibatches of PPO updates on
        one [T, E] trajectory. Each epoch shuffles the T·E samples with
        `permutations[epoch]` when given, else a permutation drawn from
        `generator`."""
        with torch.no_grad():
            v_t = self.critic_apply(params.critic_params, traj_batch.next_obs)
            d_t = self.gamma * (1.0 - traj_batch.done.to(torch.float32))
            advantages, targets = truncated_generalized_advantage_estimation(
                traj_batch.reward * self.reward_scale,
                d_t,
                self.gae_lambda,
                v_tm1=traj_batch.value,
                v_t=v_t,
                truncation_t=traj_batch.truncated.to(torch.float32),
                standardize_advantages=self.standardize_advantages,
                impl=self.multistep_impl,
            )

        samples = (
            traj_batch.obs, traj_batch.action, traj_batch.log_prob, traj_batch.value,
            advantages, targets,
        )
        flat = tree_merge_leading_dims(samples, 2)
        batch_size = advantages.numel()
        per_epoch = []
        for epoch in range(self.epochs):
            if permutations is not None:
                permutation = permutations[epoch].to(advantages.device)
            else:
                permutation = torch.randperm(
                    batch_size, generator=generator, device=advantages.device
                )
            minibatches = tree_map(
                lambda x: x.index_select(0, permutation).reshape(
                    (self.num_minibatches, -1) + x.shape[1:]
                ),
                flat,
            )
            per_minibatch = []
            for i in range(self.num_minibatches):
                batch = tree_map(lambda x: x[i], minibatches)
                params, opt_states, loss_info = self._update_minibatch(params, opt_states, batch)
                per_minibatch.append(loss_info)
            per_epoch.append(tree_stack(per_minibatch))
        return UpdateResult(params, opt_states, tree_stack(per_epoch), advantages, targets)

    def update_step(
        self, state: PPOLearnerState
    ) -> Tuple[PPOLearnerState, Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
        state, traj_batch = self.rollout(state)
        result = self.update(state.params, state.opt_states, traj_batch, state.generator)
        state = state._replace(params=result.params, opt_states=result.opt_states)
        return state, (traj_batch.info, result.loss_info)

    def __call__(self, state: PPOLearnerState) -> ExperimentOutput:
        episode_info, loss_info = [], []
        for _ in range(self.num_updates_per_eval):
            state, (episodes, losses_) = self.update_step(state)
            episode_info.append(episodes)
            loss_info.append(losses_)
        return ExperimentOutput(
            learner_state=state,
            episode_metrics=tree_stack(episode_info),
            train_metrics=tree_stack(loss_info),
        )


def get_learner_fn(
    env: envs.Environment,
    apply_fns: Tuple[Callable, Callable],
    update_fns: Tuple[ClipAdam, ClipAdam],
    config: Any,
) -> PPOLearner:
    return PPOLearner(env, apply_fns, update_fns, config)


def make_apply_fn(network: torch.nn.Module) -> Callable[[Dict[str, torch.Tensor], Any], Any]:
    """`apply(params, observation)`: the network with `params` swapped in."""
    return lambda params, observation: functional_call(network, params, (observation,))


def build_networks(env: envs.Environment, config: Any, generator: torch.Generator):
    """Actor/critic construction from the network config. Each module takes
    its input width from the one before it; the weights draw from `generator`."""
    from stoix_tpu_torch.networks.base import FeedForwardActor, FeedForwardCritic

    net_cfg = config.network
    dummy_obs = env.observation_value()

    def build(cfg: Any, head_key: str, head_kwargs: dict):
        input_layer = config_lib.instantiate(cfg.input_layer)
        in_dim = int(input_layer(dummy_obs).shape[-1])
        torso = config_lib.instantiate(cfg.pre_torso, input_dim=in_dim, generator=generator)
        head = config_lib.instantiate(
            cfg[head_key], input_dim=torso.output_dim, generator=generator, **head_kwargs
        )
        return head, torso, input_layer

    actor_cfg = net_cfg.actor_network
    actor_network = FeedForwardActor(
        *build(actor_cfg, "action_head",
               anakin.head_kwargs_for_env(actor_cfg.action_head, env))
    )
    critic_network = FeedForwardCritic(*build(net_cfg.critic_network, "critic_head", {}))
    return actor_network, critic_network


def learner_setup(
    env: envs.Environment, config: Any, device: torch.device, seed: int
) -> AnakinSetup:
    """Build the networks (initialised on the CPU from `seed`, then moved to
    `device`), the optimizers, the learner and its initial state."""
    config.system.action_dim = env.num_actions
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)

    actor_network, critic_network = build_networks(
        env, config, anakin.make_generator(init_seed, torch.device("cpu"))
    )
    actor_network.to(device)
    critic_network.to(device)
    epochs, num_minibatches = int(config.system.epochs), int(config.system.num_minibatches)
    max_grad_norm = float(config.system.max_grad_norm)
    actor_optim = ClipAdam(
        make_learning_rate(float(config.system.actor_lr), config, epochs, num_minibatches),
        max_grad_norm, eps=1e-5,
    )
    critic_optim = ClipAdam(
        make_learning_rate(float(config.system.critic_lr), config, epochs, num_minibatches),
        max_grad_norm, eps=1e-5,
    )
    actor_params = {k: v.detach() for k, v in actor_network.named_parameters()}
    critic_params = {k: v.detach() for k, v in critic_network.named_parameters()}

    actor_apply, critic_apply = make_apply_fn(actor_network), make_apply_fn(critic_network)
    learner = get_learner_fn(env, (actor_apply, critic_apply), (actor_optim, critic_optim), config)

    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(env_seed, device)
    )
    learner_state = PPOLearnerState(
        params=ActorCriticParams(actor_params, critic_params),
        opt_states=ActorCriticOptStates(
            actor_optim.init(actor_params), critic_optim.init(critic_params)
        ),
        generator=anakin.make_generator(step_seed, device),
        env_state=env_state,
        timestep=timestep,
    )
    return AnakinSetup(
        learn=learner,
        learner_state=learner_state,
        eval_act_fn=get_distribution_act_fn(config, actor_apply),
        eval_params_fn=lambda s: s.params.actor_params,
    )


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin PPO; returns the final evaluation episode-return mean.
    Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_ppo.yaml", sys.argv[1:]
    )
    return run_experiment(config)


if __name__ == "__main__":
    main()
