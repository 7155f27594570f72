"""Anakin Sampled AlphaZero (counterpart of
stoix_tpu/systems/search/ff_sampled_az.py): continuous actions through a
SAMPLED action set (Hubert et al. 2021), on the replay learner of ff_az.py.

Acting: K = `num_sampled_actions` actions drawn from the actor at each root
form the discrete action set the search runs over (uniform priors), blended
toward uniform noise on the action space's bounds
(`root_exploration_fraction`, `mcts.blend_root_action_noise`); the
simulator is the pristine env, as in ff_az; each expanded node draws a
FRESH set of K actions from the actor at its own state. The draws come from
the replica's generator in `draw_noise`: the root's K normals [K, E, A], the
blend's uniforms [E, K, A], the search's Dirichlet and Gumbel noise and the
per-node normals [S, E, K, A] (the JAX package splits each simulation's key
into K keys there). Each step stores obs, the sampled set, the visit
weights, the root's search value, the critic's value of the true successor,
reward, discount and truncation.

Each epoch, on [B, L] sequences a replica (ff_sampled_az.py:165-215): GAE
over the STORED search values (batch-major, every replica's batch in ONE
call: one launch of B1's GAE entry an epoch, `epochs` 64 an update at the
default); the actor's loss -mean(sum_i w_i log pi(a_i | s)) - `ent_coef` .
entropy over the stored set, the critic's `vf_coef` . 0.5 mean((V - G)^2),
over the first L - 1 steps; the gradients averaged over the replicas, then
the data ranks; one clip + Adam step each.

The JAX ff_sampled_az does not read `system.update_guard`; the port
refuses it (ROADMAP C20).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams, OffPolicyLearnerState
from stoix_tpu_torch.evaluator import get_distribution_act_fn
from stoix_tpu_torch.search import mcts
from stoix_tpu_torch.systems import anakin, off_policy_core as core
from stoix_tpu_torch.systems.ddpg.ff_ddpg import join_metrics
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.systems.search.ff_az import (
    SearchReplayLearner, _clip_adam_steps, _truncated, make_simulator, refuse_ignored_knobs,
    replay_buffer, replay_value_targets, scalars, search_policy_fn,
)
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam, make_learning_rate
from stoix_tpu_torch.utils.tree import tree_map, tree_merge_leading_dims


class SampledNoise(NamedTuple):
    samples: torch.Tensor  # [K, E, A] standard normals of the root's sampled set
    blend: Optional[torch.Tensor]  # [E, K, A] uniforms of the root blend (None: no blend)
    search: mcts.SearchNoise  # its `recurrent`: [S, E, K, A] per-node normals


class SampledSearch:
    """The sampled search's shared parts: the sizes, the noise and the root
    set. `node_actions(dist, noise)` draws a node's [E, K, A] set."""

    def __init__(self, env: envs.Environment, config: Any):
        system = config.system
        self.gamma = float(system.gamma)
        self.num_simulations = int(system.get("num_simulations", 16))
        self.max_depth = int(system.get("max_depth") or self.num_simulations)
        self.num_samples = int(system.get("num_sampled_actions", 8))
        self.root_noise = float(system.get("root_exploration_fraction", 0.1))
        self.policy_fn, self.dirichlet_fraction = search_policy_fn(config)
        self.action_dim = int(np.asarray(env.action_value()).shape[-1])
        space = env.action_space()
        # Per-dimension bounds, broadcast against the trailing action axis.
        self.bounds = (np.asarray(getattr(space, "low", -1.0), np.float32),
                       np.asarray(getattr(space, "high", 1.0), np.float32))

    def draw_noise(self, generator: torch.Generator, batch: int) -> SampledNoise:
        device = generator.device
        k, a = self.num_samples, self.action_dim
        samples = torch.randn((k, batch, a), generator=generator, device=device)
        blend = (torch.rand((batch, k, a), generator=generator, device=device)
                 if self.root_noise > 0.0 else None)
        search = mcts.draw_noise(generator, batch, k, self.dirichlet_fraction, device=device)
        recurrent = torch.randn((self.num_simulations, batch, k, a), generator=generator,
                                device=device)
        return SampledNoise(samples, blend, search._replace(recurrent=recurrent))

    @staticmethod
    def node_actions(dist: Any, normals: torch.Tensor) -> torch.Tensor:
        """[E, K, A]: the K draws of `dist` ([E] batch) from normals [E, K, A]."""
        return dist.sample(noise=normals.transpose(0, 1)).transpose(0, 1)

    def root_actions(self, dist: Any, noise: SampledNoise) -> torch.Tensor:
        sampled = dist.sample(noise=noise.samples).transpose(0, 1)  # [E, K, A]
        if self.root_noise > 0.0:
            # Root exploration: the set blended toward bounded noise, so the
            # search sees actions a collapsing policy would never draw.
            sampled = mcts.blend_root_action_noise(noise.blend, sampled, self.root_noise,
                                                   *self.bounds)
        return sampled

    def run(self, params: Any, noise: SampledNoise, value: torch.Tensor, embedding: Dict,
            recurrent_fn: mcts.RecurrentFn) -> Tuple[torch.Tensor, mcts.PolicyOutput]:
        """The search over the root's set; returns (the chosen actions
        [E, A], the search output)."""
        sampled = embedding["actions"]
        root = mcts.RootFnOutput(prior_logits=value.new_zeros(value.shape + (self.num_samples,)),
                                 value=value, embedding=embedding)
        out = self.policy_fn(params, noise.search, root, recurrent_fn, self.num_simulations,
                             max_depth=self.max_depth)
        rows = torch.arange(sampled.shape[0], device=sampled.device)
        return sampled[rows, out.action], out


class SampledAZActing(SampledSearch):
    """ff_sampled_az's acting (ff_sampled_az.py:65-147)."""

    def __init__(self, env: envs.Environment, sim_env: envs.Environment,
                 apply_fns: Tuple[Callable, Callable], config: Any):
        super().__init__(env, config)
        self.sim_env = sim_env
        self.actor_apply, self.critic_apply = apply_fns

    def recurrent_fn(self, params: ActorCriticParams, normals: torch.Tensor,
                     action_idx: torch.Tensor, embedding: Dict):
        actions = embedding["actions"]
        rows = torch.arange(actions.shape[0], device=actions.device)
        new_state, ts = self.sim_env.step(embedding["state"], actions[rows, action_idx])
        value = self.critic_apply(params.critic_params, ts.observation)
        # Per-node RESAMPLING: the expanded node's set is drawn fresh from the
        # policy at its state.
        dist = self.actor_apply(params.actor_params, ts.observation)
        out = mcts.RecurrentFnOutput(
            reward=ts.reward, discount=self.gamma * ts.discount,
            prior_logits=value.new_zeros(value.shape + (self.num_samples,)), value=value)
        return out, {"state": new_state, "actions": self.node_actions(dist, normals)}

    def act(self, params: ActorCriticParams, noise: SampledNoise, sim_state: Any,
            observation: Any):
        sampled = self.root_actions(self.actor_apply(params.actor_params, observation), noise)
        value = self.critic_apply(params.critic_params, observation)
        action, out = self.run(params, noise, value, {"state": sim_state, "actions": sampled},
                               self.recurrent_fn)
        return action, {"sampled_actions": sampled, "search_policy": out.action_weights,
                        "search_value": out.search_value}

    def record(self, params, last_timestep, action, timestep, extras):
        return {
            "obs": last_timestep.observation,
            **extras,
            # The critic's value of the TRUE successor, for truncated steps
            # (on Pendulum every episode ends by truncation).
            "bootstrap_value": self.critic_apply(params.critic_params,
                                                 timestep.extras["next_obs"]),
            "reward": timestep.reward,
            "discount": timestep.discount,
            "truncated": _truncated(timestep),
            "info": timestep.extras["episode_metrics"],
        }


def sampled_log_probs(dist: Any, sampled: torch.Tensor) -> torch.Tensor:
    """log pi(a_i | s) [N, K] of each of the K actions [N, K, A] of a set."""
    return dist.log_prob(sampled.transpose(0, 1)).transpose(0, 1)


class SampledAZUpdate:
    """`update_from_batch` of ff_sampled_az over lists of one [B, L]
    sequence batch a replica."""

    def __init__(self, apply_fns: Tuple[Callable, Callable], optims: Tuple[ClipAdam, ClipAdam],
                 config: Any):
        self.actor_apply, self.critic_apply = apply_fns
        self.optims = optims
        system = config.system
        self.gamma = float(system.gamma)
        self.gae_lambda = float(system.get("gae_lambda", 0.95))
        self.ent_coef = float(system.get("ent_coef", 0.005))
        self.vf_coef = float(system.get("vf_coef", 0.5))
        self.multistep_impl = str(system.get("multistep_impl", "scan"))
        self.data_group = anakin.data_group()

    def actor_loss(self, actor_params, obs, sampled, weights):
        dist = self.actor_apply(actor_params, obs)
        ce = -torch.mean(torch.sum(weights * sampled_log_probs(dist, sampled), dim=-1))
        # The entropy bonus keeps the Gaussian from collapsing before the
        # search has found better actions to weight.
        entropy = dist.entropy().mean()
        return ce - self.ent_coef * entropy, {"actor_loss": ce, "entropy": entropy}

    def critic_loss(self, critic_params, obs, targets):
        loss = 0.5 * torch.mean((self.critic_apply(critic_params, obs) - targets) ** 2)
        return self.vf_coef * loss, {"value_loss": loss}

    def __call__(self, params: List[ActorCriticParams], opt_states: List[ActorCriticOptStates],
                 batches: List[Dict]):
        with torch.no_grad():
            targets = replay_value_targets(batches, self.gamma, self.gae_lambda,
                                           self.multistep_impl)
        actor_grads, critic_grads, metrics = [], [], []
        for p, batch, g in zip(params, batches, targets):
            obs, sampled, weights, g = tree_merge_leading_dims(
                tree_map(lambda x: x[:, :-1], (batch["obs"], batch["sampled_actions"],
                                                batch["search_policy"])) + (g,), 2)
            a_grads, a_metrics = core.value_and_grad(self.actor_loss, p.actor_params, obs,
                                                     sampled, weights)
            c_grads, c_metrics = core.value_and_grad(self.critic_loss, p.critic_params, obs, g)
            actor_grads.append(a_grads)
            critic_grads.append(c_grads)
            metrics.append({**a_metrics, **c_metrics})
        actor_grads, critic_grads = anakin.data_mean(
            (anakin.mean_gradients(actor_grads), anakin.mean_gradients(critic_grads)),
            self.data_group)
        new_params, new_opts = _clip_adam_steps(self.optims, params, opt_states, actor_grads,
                                                critic_grads)
        return new_params, new_opts, join_metrics(metrics)


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    """The actor and critic (initialised on the CPU from `seed`, then moved
    to `device`), their clip + Adam, the simulator, a trajectory buffer a
    replica, the learner and its initial state."""
    refuse_ignored_knobs(config, "ff_sampled_az")
    config.system.action_dim = env.num_actions
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)
    actor, critic = ff_ppo.build_networks(env, config,
                                          anakin.make_generator(init_seed, torch.device("cpu")))
    actor.to(device)
    critic.to(device)
    apply_fns = (ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic))
    epochs, max_grad_norm = int(config.system.epochs), float(config.system.max_grad_norm)
    optims = tuple(ClipAdam(make_learning_rate(float(config.system[key]), config, epochs),
                            max_grad_norm, eps=1e-5) for key in ("actor_lr", "critic_lr"))
    params, opt_states, generator = ff_ppo.initial_train_state(
        actor, critic, optims, config, device, step_seed)
    acting = SampledAZActing(env, make_simulator(config), apply_fns, config)
    buffer = replay_buffer(config, 8)
    item = {"obs": tree_map(lambda x: x.to(device), env.observation_value()),
            "sampled_actions": torch.zeros((acting.num_samples, acting.action_dim),
                                           device=device),
            "search_policy": torch.zeros((acting.num_samples,), device=device),
            **scalars(device, "search_value", "bootstrap_value", "reward", "discount",
                      "truncated")}
    update_batch = int(config.arch.get("update_batch_size", 1))
    learner = SearchReplayLearner(env, buffer, config, SampledAZUpdate(apply_fns, optims, config),
                                  acting)
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    state = OffPolicyLearnerState(
        params=params, opt_states=opt_states,
        buffer_state=anakin.join_per_replica([buffer.init(item) for _ in range(update_batch)]),
        generator=generator, env_state=env_state, timestep=timestep)
    return AnakinSetup(
        learn=learner, learner_state=state,
        eval_act_fn=get_distribution_act_fn(config, apply_fns[0]),
        eval_params_fn=lambda s: anakin.split_replicas(s.params, update_batch)[0].actor_params)


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin Sampled AlphaZero; returns the final evaluation
    episode-return mean. Runs on CUDA unless the caller asks for another
    device."""
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_sampled_az.yaml",
        sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
