"""Anakin AlphaZero (counterpart of stoix_tpu/systems/search/ff_az.py):
expert iteration with the REAL environment as the search's simulator.

Acting: each step, every replica builds the search root from its actor's
logits and critic's value on its envs' observations, with the envs' core
states (below every wrapper's `inner`) as the root's embedding, and runs
`mcts.muzero_policy` (or `gumbel_muzero_policy`, `system.search_method`)
through a pristine copy of the env (`envs.make_single`: no step limit, no
auto-reset), one `sim_env.step` a simulation on the B selected edges. The
tree stores the core states' tensors, one slot a node; the simulator's
state carries the replica's step generator in place of the live env's, so
the simulator never draws from the env's stream (IdentityGame's random
targets: ROADMAP C21). The search's noise (Dirichlet, Gumbel) is drawn from
the replica's generator (`draw_noise`) and handed to the search.

On-policy (`system.use_replay_buffer: false`), one update step:

  1. rollout: `rollout_length` searched steps, storing the ExItTransition;
  2. the targets: truncation-aware GAE over the ROOT search values, v_t the
     next step's search value, or the critic's value of the true successor
     at truncations and the rollout's last step (ff_az.py:170-191), ONE
     launch of B1's GAE entry over [T, U.E] under
     `system.multistep_impl: pallas`;
  3. `epochs` x `num_minibatches` of the actor's cross-entropy against the
     visit weights (minus `ent_coef` . entropy) and `vf_coef` . 0.5 . the
     squared error of the critic, each epoch's samples shuffled by a
     permutation from the replica's generator; both gradients averaged over
     the replicas, then the data ranks, in one all-reduce; the two clip +
     Adam steps.

Replay (`system.use_replay_buffer: true`, ff_az.py:229-355): each step also
stores the critic's value of the true successor; the steps go to the
replica's trajectory buffer as [E_u, T]; each of `epochs` epochs samples
[B, L] sequences a replica and recomputes GAE over the STORED search values
(batch-major, every replica's batch in ONE call: one launch of B1's GAE
entry an epoch), then one actor (cross-entropy, no entropy term) and one
critic step.

The JAX ff_az reads neither `system.update_guard` nor, in replay mode,
`system.ent_coef`; the port refuses both set (ROADMAP C20).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import (
    ActorCriticOptStates, ActorCriticParams, ExperimentOutput, OffPolicyLearnerState,
    OnPolicyLearnerState,
)
from stoix_tpu_torch.buffers import make_trajectory_buffer
from stoix_tpu_torch.evaluator import get_distribution_act_fn
from stoix_tpu_torch.ops import truncated_generalized_advantage_estimation
from stoix_tpu_torch.resilience import guards
from stoix_tpu_torch.search import mcts
from stoix_tpu_torch.systems import anakin, off_policy_core as core
from stoix_tpu_torch.systems.ddpg.ff_ddpg import join_metrics
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import _cat
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam, apply_updates, make_learning_rate
from stoix_tpu_torch.utils.tree import tree_map, tree_merge_leading_dims, tree_stack


class ExItTransition(NamedTuple):
    done: torch.Tensor
    truncated: torch.Tensor
    action: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    search_policy: torch.Tensor  # [E, A] visit weights: the policy target
    search_value: torch.Tensor
    obs: Any
    next_obs: Any
    info: Dict[str, Any]


def refuse_ignored_knobs(config: Any, system_name: str, keys: Sequence[str] = ()) -> None:
    """Raise NotImplementedError, naming the key, for a knob the JAX search
    learner does not read (ROADMAP C20): `system.update_guard` away from
    off, and each of `keys` that the config sets."""
    refused = ["system.update_guard"] if guards.resolve_mode(config) != "off" else []
    refused += [key for key in keys if config.system.get(key.split(".", 1)[1]) is not None]
    if refused:
        raise NotImplementedError(f"not ported for {system_name} (the JAX package's "
                                  f"{system_name} ignores it): " + ", ".join(refused))


def unwrap_env_state(state: Any) -> Any:
    """The core env state below every wrapper state's `inner`."""
    while hasattr(state, "inner"):
        state = state.inner
    return state


def simulator_state(env_state: Any, index: int, update_batch: int,
                    generator: torch.Generator) -> Any:
    """Replica `index`'s envs' core state for the simulator: its tensors
    (views) with `generator` in place of the live env's."""
    return anakin.env_group(unwrap_env_state(env_state), index, update_batch, 0)._replace(
        generator=generator)


def make_simulator(config: Any) -> envs.Environment:
    """The pristine simulator: the raw env of `env.scenario`, with no
    wrapper (no step limit, no auto-reset), so the search never resets."""
    scenario = config.env.scenario
    return envs.make_single(scenario.name if hasattr(scenario, "name") else scenario,
                            config.env.get("env_name"),
                            **dict(config.env.get("kwargs", {}) or {}))


def search_policy_fn(config: Any) -> Tuple[Callable, float]:
    """(the search's policy, its root Dirichlet fraction) for
    `system.search_method`: muzero_policy at its default 0.25, or
    gumbel_muzero_policy, which adds no root noise."""
    if str(config.system.get("search_method", "muzero")) == "gumbel":
        return mcts.gumbel_muzero_policy, 0.0
    return mcts.muzero_policy, 0.25


class AZSearch:
    """The AZ search step shared by the on-policy and replay learners
    (ff_az.py:61-101): the root from the live actor and critic, MCTS
    through the simulator; returns (root value, search output)."""

    def __init__(self, sim_env: envs.Environment, apply_fns: Tuple[Callable, Callable],
                 config: Any):
        self.sim_env = sim_env
        self.actor_apply, self.critic_apply = apply_fns
        self.gamma = float(config.system.gamma)
        self.num_simulations = int(config.system.get("num_simulations", 16))
        self.max_depth = int(config.system.get("max_depth", self.num_simulations))
        self.policy_fn, self.dirichlet_fraction = search_policy_fn(config)
        self.num_actions = int(sim_env.num_actions)

    def draw_noise(self, generator: torch.Generator, batch: int) -> mcts.SearchNoise:
        return mcts.draw_noise(generator, batch, self.num_actions, self.dirichlet_fraction,
                               device=generator.device)

    def recurrent_fn(self, params: ActorCriticParams, noise: Any, action: torch.Tensor,
                     state: Any) -> Tuple[mcts.RecurrentFnOutput, Any]:
        new_state, ts = self.sim_env.step(state, action)
        prior = self.actor_apply(params.actor_params, ts.observation)
        value = self.critic_apply(params.critic_params, ts.observation)
        return mcts.RecurrentFnOutput(reward=ts.reward, discount=self.gamma * ts.discount,
                                      prior_logits=prior.logits, value=value), new_state

    def __call__(self, params: ActorCriticParams, noise: mcts.SearchNoise, state: Any,
                 observation: Any) -> Tuple[torch.Tensor, mcts.PolicyOutput]:
        prior = self.actor_apply(params.actor_params, observation)
        value = self.critic_apply(params.critic_params, observation)
        root = mcts.RootFnOutput(prior_logits=prior.logits, value=value, embedding=state)
        return value, self.policy_fn(params, noise, root, self.recurrent_fn,
                                     self.num_simulations, max_depth=self.max_depth)


def _policy_losses(actor_apply: Callable, critic_apply: Callable, vf_coef: float,
                   ent_coef: Optional[float]) -> Tuple[Callable, Callable]:
    """(actor_loss, critic_loss): the cross-entropy against the visit
    weights (minus `ent_coef` . entropy, if given) and `vf_coef` . 0.5
    mean((V(s) - targets)^2)."""

    def actor_loss(actor_params, obs, search_policy):
        dist = actor_apply(actor_params, obs)
        ce = -torch.sum(search_policy * torch.log_softmax(dist.logits, dim=-1), dim=-1)
        loss = torch.mean(ce)
        entropy = dist.entropy().mean()
        total = loss if ent_coef is None else loss - ent_coef * entropy
        return total, {"actor_loss": loss, "entropy": entropy}

    def critic_loss(critic_params, obs, targets):
        loss = 0.5 * torch.mean((critic_apply(critic_params, obs) - targets) ** 2)
        return vf_coef * loss, {"value_loss": loss}

    return actor_loss, critic_loss


def _clip_adam_steps(optims: Tuple[ClipAdam, ClipAdam], params: Sequence[ActorCriticParams],
                     opt_states: Sequence[ActorCriticOptStates], actor_grads: Dict,
                     critic_grads: Dict) -> Tuple[List, List]:
    """Each replica's actor and critic clip + Adam steps on the averaged gradients."""
    new_params, new_opts = [], []
    for p, opt in zip(params, opt_states):
        a_updates, a_opt = optims[0].update(actor_grads, opt.actor_opt_state)
        c_updates, c_opt = optims[1].update(critic_grads, opt.critic_opt_state)
        new_params.append(ActorCriticParams(apply_updates(p.actor_params, a_updates),
                                            apply_updates(p.critic_params, c_updates)))
        new_opts.append(ActorCriticOptStates(a_opt, c_opt))
    return new_params, new_opts


class AZLearner:
    """The on-policy learner: `learner(state) -> ExperimentOutput` runs
    `arch.num_updates_per_eval` update steps; `rollout` and `update` are the
    two halves of one step, `env_step` one searched step of the rollout."""

    def __init__(self, env: envs.Environment, search: AZSearch,
                 apply_fns: Tuple[Callable, Callable], optims: Tuple[ClipAdam, ClipAdam],
                 config: Any):
        self.env, self.search = env, search
        self.actor_apply, self.critic_apply = apply_fns
        self.optims = optims
        system = config.system
        self.gamma = float(system.gamma)
        self.gae_lambda = float(system.get("gae_lambda", 0.95))
        self.multistep_impl = str(system.get("multistep_impl", "scan"))
        self.actor_loss, self.critic_loss = _policy_losses(
            self.actor_apply, self.critic_apply, float(system.get("vf_coef", 0.5)),
            float(system.get("ent_coef", 0.0)))
        self.rollout_length = int(system.rollout_length)
        self.epochs = int(system.epochs)
        self.num_minibatches = int(system.num_minibatches)
        self.num_updates_per_eval = int(config.arch.num_updates_per_eval)
        self.update_batch = int(config.arch.get("update_batch_size", 1))
        self.data_group = anakin.data_group()

    def group(self, tree: Any, index: int, dim: int) -> Any:
        return anakin.env_group(tree, index, self.update_batch, dim)

    @torch.no_grad()
    def env_step(self, state: OnPolicyLearnerState,
                 noises: Optional[Sequence[mcts.SearchNoise]] = None
                 ) -> Tuple[OnPolicyLearnerState, ExItTransition]:
        """One searched step of every env: each replica's search on its envs
        (its noise from `noises`, else drawn from its generator)."""
        params = anakin.split_replicas(state.params, self.update_batch)
        generators = anakin.per_replica(state.generator, self.update_batch)
        observation = state.timestep.observation
        outs = []
        for u, (p, generator) in enumerate(zip(params, generators)):
            obs = self.group(observation, u, 0)
            sim_state = simulator_state(state.env_state, u, self.update_batch, generator)
            noise = (self.search.draw_noise(generator, obs.agent_view.shape[0])
                     if noises is None else noises[u])
            value, out = self.search(p, noise, sim_state, obs)
            outs.append((out.action, value, out.action_weights, out.search_value))
        action, value, weights, search_value = (_cat(parts, 0) for parts in zip(*outs))
        env_state, timestep = self.env.step(state.env_state, action)
        transition = ExItTransition(
            done=timestep.discount == 0.0,
            truncated=timestep.last() & (timestep.discount != 0.0),
            action=action, value=value, reward=timestep.reward, search_policy=weights,
            search_value=search_value, obs=observation, next_obs=timestep.extras["next_obs"],
            info=timestep.extras["episode_metrics"])
        return state._replace(env_state=env_state, timestep=timestep), transition

    def rollout(self, state: OnPolicyLearnerState) -> Tuple[OnPolicyLearnerState, ExItTransition]:
        """`rollout_length` searched steps, stacked to [T, E, ...]."""
        steps = []
        for _ in range(self.rollout_length):
            state, transition = self.env_step(state)
            steps.append(transition)
        return state, tree_stack(steps)

    @torch.no_grad()
    def targets(self, params: Sequence[ActorCriticParams], traj: ExItTransition) -> torch.Tensor:
        """The value targets [T, U.E]: GAE over the root search values, in
        one call (ff_az.py:181-191)."""
        v_t_net = _cat([self.critic_apply(p.critic_params, self.group(traj.next_obs, u, 1))
                        for u, p in enumerate(params)], 1)
        sv_next = torch.cat([traj.search_value[1:], v_t_net[-1:]], 0)
        v_t = torch.where(traj.truncated, v_t_net, sv_next)
        _, targets = truncated_generalized_advantage_estimation(
            traj.reward, self.gamma * (1.0 - traj.done.to(torch.float32)), self.gae_lambda,
            v_tm1=traj.search_value, v_t=v_t, truncation_t=traj.truncated.to(torch.float32),
            impl=self.multistep_impl)
        return targets

    def update(self, params: Any, opt_states: Any, traj: ExItTransition, generator: Any = None,
               permutations: Optional[Sequence[Any]] = None) -> Tuple[Any, Any, Dict]:
        """The targets, then epochs x minibatches of updates on one [T, E]
        trajectory. Each epoch shuffles every replica's T.E samples with
        `permutations[epoch]` when given (a tensor at U = 1, else one a
        replica), else with a permutation from the replica's generator."""
        replica_params = anakin.split_replicas(params, self.update_batch)
        replica_opts = anakin.split_replicas(opt_states, self.update_batch)
        generators = ([None] * self.update_batch if generator is None
                      else anakin.per_replica(generator, self.update_batch))
        targets = self.targets(replica_params, traj)
        samples = (traj.obs, traj.search_policy, targets)
        flat = [tree_merge_leading_dims(self.group(samples, u, 1), 2)
                for u in range(self.update_batch)]
        batch_size = targets.numel() // self.update_batch
        per_epoch = []
        for epoch in range(self.epochs):
            minibatches = []
            for u in range(self.update_batch):
                if permutations is not None:
                    given = permutations[epoch]
                    permutation = (given if self.update_batch == 1 else given[u]).to(
                        targets.device)
                else:
                    permutation = torch.randperm(batch_size, generator=generators[u],
                                                 device=targets.device)
                minibatches.append(tree_map(lambda x: x.index_select(0, permutation).reshape(
                    (self.num_minibatches, -1) + x.shape[1:]), flat[u]))
            per_minibatch = []
            for i in range(self.num_minibatches):
                batches = [tree_map(lambda x: x[i], mb) for mb in minibatches]
                replica_params, replica_opts, info = self.update_minibatch(
                    replica_params, replica_opts, batches)
                per_minibatch.append(info)
            per_epoch.append(tree_stack(per_minibatch))
        return (anakin.join_replicas(replica_params), anakin.join_replicas(replica_opts),
                tree_stack(per_epoch))

    def update_minibatch(self, params: List[ActorCriticParams],
                         opt_states: List[ActorCriticOptStates], batches: Sequence[Tuple]):
        actor_grads, critic_grads, metrics = [], [], []
        for p, (obs, search_policy, targets) in zip(params, batches):
            a_grads, a_metrics = core.value_and_grad(self.actor_loss, p.actor_params, obs,
                                                     search_policy)
            c_grads, c_metrics = core.value_and_grad(self.critic_loss, p.critic_params, obs,
                                                     targets)
            actor_grads.append(a_grads)
            critic_grads.append(c_grads)
            metrics.append({**a_metrics, **c_metrics})
        actor_grads, critic_grads = anakin.data_mean(
            (anakin.mean_gradients(actor_grads), anakin.mean_gradients(critic_grads)),
            self.data_group)
        new_params, new_opts = _clip_adam_steps(self.optims, params, opt_states, actor_grads,
                                                critic_grads)
        return new_params, new_opts, join_metrics(metrics)

    def update_step(self, state: OnPolicyLearnerState) -> Tuple[OnPolicyLearnerState, Tuple]:
        state, traj = self.rollout(state)
        params, opt_states, metrics = self.update(state.params, state.opt_states, traj,
                                                  state.generator)
        return state._replace(params=params, opt_states=opt_states), (traj.info, metrics)

    def __call__(self, state: OnPolicyLearnerState) -> ExperimentOutput:
        episode_info, loss_info = [], []
        for _ in range(self.num_updates_per_eval):
            state, (episodes, losses_) = self.update_step(state)
            episode_info.append(episodes)
            loss_info.append(losses_)
        return ExperimentOutput(state, tree_stack(episode_info), anakin.data_mean(
            tree_stack(loss_info), self.data_group, kind="metrics"))


# ---------------------------------------------------------------- replay


class SearchReplayLearner(core.OffPolicyLearner):
    """The off-policy learner of the replay search systems (ff_az in replay
    mode, ff_mz, ff_sampled_az, ff_sampled_mz): its acting reads the envs'
    core states, so each step asks the system's `acting` for

        acting.draw_noise(generator, batch) -> the step's noise,
        acting.act(params, noise, sim_state, observation) -> (action, extras),
        acting.record(params, last_timestep, action, timestep, extras) -> dict,

    each replica on its envs (the dict: what the buffer stores of the step,
    and its episode "info", which it does not). The rest is
    OffPolicyLearner's: [E_u, T] trajectories added to the replica's buffer,
    `epochs` epochs of `update_from_batch` on sampled sequences."""

    def __init__(self, env: envs.Environment, buffer: Any, config: Any,
                 update_from_batch: core.UpdateFn, acting: Any):
        super().__init__(env, buffer, config, update_from_batch, act_in_env=None, store=None)
        self.acting = acting

    @torch.no_grad()
    def env_step(self, state: OffPolicyLearnerState, noises: Optional[Sequence[Any]] = None
                 ) -> Tuple[OffPolicyLearnerState, Dict]:
        """One searched step of every env (each replica's noise from
        `noises`, else drawn from its generator); returns what is stored."""
        params = anakin.split_replicas(state.params, self.update_batch)
        generators = anakin.per_replica(state.generator, self.update_batch)
        observation, group = state.timestep.observation, anakin.env_group
        acted = []
        for u, (p, generator) in enumerate(zip(params, generators)):
            sim_state = simulator_state(state.env_state, u, self.update_batch, generator)
            obs = group(observation, u, self.update_batch, 0)
            noise = (self.acting.draw_noise(generator, obs.agent_view.shape[0])
                     if noises is None else noises[u])
            acted.append(self.acting.act(p, noise, sim_state, obs))
        action = _cat([a for a, _ in acted], 0)
        env_state, timestep = self.env.step(state.env_state, action)
        data = [self.acting.record(p, group(state.timestep, u, self.update_batch, 0), a,
                                   group(timestep, u, self.update_batch, 0), extras)
                for u, (p, (a, extras)) in enumerate(zip(params, acted))]
        data = data[0] if len(data) == 1 else tree_map(lambda *xs: torch.cat(xs), *data)
        return state._replace(env_state=env_state, timestep=timestep), data

    def rollout(self, state: OffPolicyLearnerState) -> Tuple[OffPolicyLearnerState, Dict]:
        """`rollout_length` searched steps, stacked to [T, E, ...] and added
        to the buffers."""
        stored = []
        for _ in range(self.rollout_length):
            state, data = self.env_step(state)
            stored.append(data)
        traj = tree_stack(stored)
        buffers = self.add(anakin.per_replica(state.buffer_state, self.update_batch), traj)
        return state._replace(buffer_state=anakin.join_per_replica(buffers)), traj


def _truncated(timestep: Any) -> torch.Tensor:
    """1.0 where a step ended its episode without termination (float32, the
    search family's one dtype for the field)."""
    return (timestep.last() & (timestep.discount != 0.0)).to(torch.float32)


class AZActing:
    """ff_az's acting in replay mode (ff_az.py:240-269)."""

    def __init__(self, search: AZSearch):
        self.search = search

    def draw_noise(self, generator: torch.Generator, batch: int) -> mcts.SearchNoise:
        return self.search.draw_noise(generator, batch)

    def act(self, params, noise, sim_state, observation):
        _, out = self.search(params, noise, sim_state, observation)
        return out.action, {"search_policy": out.action_weights,
                            "search_value": out.search_value}

    def record(self, params, last_timestep, action, timestep, extras):
        return {
            "obs": last_timestep.observation,
            "search_policy": extras["search_policy"],
            "search_value": extras["search_value"],
            # The critic's value of the TRUE successor, recorded at collection:
            # the replay GAE needs it at truncations, where the next stored
            # search value is the following episode's first root's.
            "bootstrap_value": self.search.critic_apply(params.critic_params,
                                                        timestep.extras["next_obs"]),
            "reward": timestep.reward,
            "discount": timestep.discount,
            "truncated": _truncated(timestep),
            "info": timestep.extras["episode_metrics"],
        }


def replay_value_targets(batches: Sequence[Dict], gamma: float, gae_lambda: float,
                         impl: str) -> List[torch.Tensor]:
    """Each replica's value targets [B, L - 1]: truncation-aware GAE over
    the STORED search values, v_t the stored true-successor value at
    truncations, every replica's batch-major sequences in ONE call."""
    sv, boot, reward, discount, truncated = (
        _cat([b[k] for b in batches], 0)
        for k in ("search_value", "bootstrap_value", "reward", "discount", "truncated"))
    truncated = truncated[:, :-1].to(torch.float32)
    v_t = torch.where(truncated > 0, boot[:, :-1], sv[:, 1:])
    _, targets = truncated_generalized_advantage_estimation(
        reward[:, :-1], gamma * discount[:, :-1], gae_lambda, v_tm1=sv[:, :-1], v_t=v_t,
        truncation_t=truncated, batch_major=True, impl=impl)
    return list(targets.split([b["reward"].shape[0] for b in batches]))


class AZReplayUpdate:
    """`update_from_batch` of ff_az in replay mode (ff_az.py:271-324) over
    lists of one [B, L] sequence batch a replica."""

    def __init__(self, apply_fns: Tuple[Callable, Callable], optims: Tuple[ClipAdam, ClipAdam],
                 config: Any):
        self.actor_apply, self.critic_apply = apply_fns
        self.optims = optims
        self.gamma = float(config.system.gamma)
        self.gae_lambda = float(config.system.get("gae_lambda", 0.95))
        self.multistep_impl = str(config.system.get("multistep_impl", "scan"))
        self.actor_loss, self.critic_loss = _policy_losses(
            self.actor_apply, self.critic_apply, float(config.system.get("vf_coef", 0.5)), None)
        self.data_group = anakin.data_group()

    def __call__(self, params: List[ActorCriticParams], opt_states: List[ActorCriticOptStates],
                 batches: List[Dict]):
        with torch.no_grad():
            targets = replay_value_targets(batches, self.gamma, self.gae_lambda,
                                           self.multistep_impl)
        actor_grads, critic_grads, metrics = [], [], []
        for p, batch, g in zip(params, batches, targets):
            obs = tree_map(lambda x: x[:, :-1], batch["obs"])
            a_grads, a_metrics = core.value_and_grad(self.actor_loss, p.actor_params, obs,
                                                     batch["search_policy"][:, :-1])
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


def replay_buffer(config: Any, default_sequence_length: int):
    """A replica's trajectory buffer (ff_az.py:413-423): the global sizes
    divided over the data ranks and replicas, at least 2 x rollout_length
    slots."""
    core.require_first_add_samplable(config)
    local_envs, sample_batch, max_length = core.trajectory_buffer_sizing(
        config, 2 * int(config.system.rollout_length))
    return make_trajectory_buffer(
        add_batch_size=local_envs,
        sample_batch_size=sample_batch,
        sample_sequence_length=int(config.system.get("sample_sequence_length",
                                                     default_sequence_length)),
        period=int(config.system.get("sample_period", 1)),
        max_length_time_axis=max_length,
    )


def scalars(device: Any, *keys: str) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in keys}


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    """The actor and critic (initialised on the CPU from `seed`, then moved
    to `device`), their clip + Adam, the simulator, and the on-policy or
    the replay learner with its initial state."""
    replay = bool(config.system.get("use_replay_buffer", False))
    refuse_ignored_knobs(config, "ff_az")
    if replay and float(config.system.get("ent_coef", 0.0)) != 0.0:
        raise NotImplementedError("not ported for ff_az (the JAX package's replay learner "
                                  "ignores it): system.ent_coef with "
                                  "system.use_replay_buffer=true")
    config.system.action_dim = env.num_actions
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)
    actor, critic = ff_ppo.build_networks(env, config,
                                          anakin.make_generator(init_seed, torch.device("cpu")))
    actor.to(device)
    critic.to(device)
    apply_fns = (ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic))
    epochs, max_grad_norm = int(config.system.epochs), float(config.system.max_grad_norm)
    # Both modes schedule a decaying rate over epochs x minibatches, as the
    # JAX package builds one pair of optimizers for either.
    minibatches = int(config.system.num_minibatches)
    optims = tuple(ClipAdam(make_learning_rate(float(config.system[key]), config, epochs,
                                               minibatches), max_grad_norm, eps=1e-5)
                   for key in ("actor_lr", "critic_lr"))
    params, opt_states, generator = ff_ppo.initial_train_state(
        actor, critic, optims, config, device, step_seed)
    search = AZSearch(make_simulator(config), apply_fns, config)
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    update_batch = int(config.arch.get("update_batch_size", 1))
    eval_params_fn = lambda s: anakin.split_replicas(s.params, update_batch)[0].actor_params  # noqa: E731
    if replay:
        buffer = replay_buffer(config, 8)
        item = {"obs": tree_map(lambda x: x.to(device), env.observation_value()),
                "search_policy": torch.zeros((env.num_actions,), device=device),
                **scalars(device, "search_value", "bootstrap_value", "reward", "discount",
                          "truncated")}
        learner = SearchReplayLearner(env, buffer, config,
                                      AZReplayUpdate(apply_fns, optims, config), AZActing(search))
        state = OffPolicyLearnerState(
            params=params, opt_states=opt_states,
            buffer_state=anakin.join_per_replica([buffer.init(item)
                                                  for _ in range(update_batch)]),
            generator=generator, env_state=env_state, timestep=timestep)
    else:
        learner = AZLearner(env, search, apply_fns, optims, config)
        state = OnPolicyLearnerState(params, opt_states, generator, env_state, timestep)
    return AnakinSetup(learn=learner, learner_state=state,
                       eval_act_fn=get_distribution_act_fn(config, apply_fns[0]),
                       eval_params_fn=eval_params_fn)


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin AlphaZero; returns the final evaluation episode-return
    mean. Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_az.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
