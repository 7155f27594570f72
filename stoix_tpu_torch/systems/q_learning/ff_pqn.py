"""Anakin PQN (counterpart of stoix_tpu/systems/q_learning/ff_pqn.py):
buffer-free parallel Q-learning. One update step:

  1. rollout: `rollout_length` epsilon-greedy env steps (epsilon annealed from
     1.0 to `training_epsilon` over `exploration_fraction` of the run, read
     off the gradient-step counter, with `system.decay_epsilon`);
  2. Q(lambda) targets over the fresh [T, E] trajectory: max_a Q of the TRUE
     next observations, lambda_t = lambda . (1 - truncated) (a truncation
     bootstraps instead of chaining the return across the auto-reset),
     discount gamma . discount. One `q_lambda` call over the whole [T, U.E]
     trajectory, so under `system.multistep_impl: pallas` one launch of B1's
     generic recurrence an update at any `arch.update_batch_size`;
  3. `epochs` times: a permutation of each replica's T.E samples, then
     `num_minibatches` updates of 0.5 . mean((Q(s, a) - target)^2), the
     replicas' gradients averaged, then over the data ranks, then each
     replica's clip + RAdam step.

Over N data-parallel ranks (systems/anakin.py) each rank runs its own
`total_num_envs // N` envs and its own Q(lambda) launch; the window's train
metrics are averaged over the ranks.

The gradient-step counter is its own optimizer state (`PQNStepCount`, found
by type, as the JAX package's `count_gradient_steps` state is), a host int.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ExperimentOutput, OnPolicyLearnerState
from stoix_tpu_torch.evaluator import get_distribution_act_fn
from stoix_tpu_torch.ops.multistep import q_lambda
from stoix_tpu_torch.systems import anakin
from stoix_tpu_torch.systems.q_learning.q_family import build_q_network, make_q_apply
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipRAdam, apply_updates, make_learning_rate
from stoix_tpu_torch.utils.tree import tree_map, tree_merge_leading_dims, tree_stack


class PQNStepCount(NamedTuple):
    """The gradient-step counter, found by type (`find_step_count`) so a change
    of the optimizer chain cannot change the epsilon annealing rate."""

    count: int


def count_gradient_steps(state: PQNStepCount) -> PQNStepCount:
    """One gradient step taken (optax's stateful no-op transform)."""
    return PQNStepCount(state.count + 1)


def find_step_count(opt_states: Any) -> int:
    counts = [x.count for x in opt_states if isinstance(x, PQNStepCount)]
    if len(counts) != 1:
        raise ValueError("expected exactly one PQNStepCount in the optimizer state")
    return counts[0]


class PQNTransition(NamedTuple):
    obs: Any
    action: torch.Tensor
    reward: torch.Tensor
    discount: torch.Tensor
    truncated: torch.Tensor
    next_obs: Any
    info: Dict[str, Any]


class PQNLearner:
    """`learner(state) -> ExperimentOutput` runs `arch.num_updates_per_eval`
    update steps; `rollout`, `targets` and `update` are one step's parts."""

    def __init__(self, env: envs.Environment, q_apply: Callable, optim: ClipRAdam, config: Any):
        self.env, self.q_apply, self.optim = env, q_apply, optim
        system = config.system
        self.gamma = float(system.gamma)
        self.lam = float(system.get("q_lambda", 0.65))
        self.train_eps = float(system.training_epsilon)
        self.decay = bool(system.get("decay_epsilon", False))
        self.rollout_length = int(system.rollout_length)
        self.epochs = int(system.epochs)
        self.num_minibatches = int(system.num_minibatches)
        self.grad_steps_per_update = self.epochs * self.num_minibatches
        self.decay_updates = max(1.0, float(system.get("exploration_fraction", 0.5))
                                 * int(config.arch.num_updates))
        self.num_updates_per_eval = int(config.arch.num_updates_per_eval)
        self.update_batch = int(config.arch.get("update_batch_size", 1))
        self.data_group = anakin.data_group()

    def epsilon(self, opt_states: Any):
        """1.0 annealed to `training_epsilon` by the gradient-step count, in
        float32 as the JAX package computes it."""
        if not self.decay:
            return self.train_eps
        f32 = np.float32
        frac = min(f32(find_step_count(opt_states)) / f32(self.grad_steps_per_update)
                   / f32(self.decay_updates), f32(1.0))
        return f32(1.0) + frac * f32(self.train_eps - 1.0)

    @torch.no_grad()
    def rollout(self, state: OnPolicyLearnerState) -> Tuple[OnPolicyLearnerState, PQNTransition]:
        params = anakin.split_replicas(state.params, self.update_batch)
        opt_states = anakin.split_replicas(state.opt_states, self.update_batch)
        generators = anakin.per_replica(state.generator, self.update_batch)
        env_state, timestep = state.env_state, state.timestep
        steps = []
        for _ in range(self.rollout_length):
            observation = timestep.observation
            parts = [self.q_apply(p, anakin.env_group(observation, u, self.update_batch, 0),
                                  self.epsilon(o)).sample(g)
                     for u, (p, o, g) in enumerate(zip(params, opt_states, generators))]
            action = parts[0] if len(parts) == 1 else torch.cat(parts)
            env_state, timestep = self.env.step(env_state, action)
            steps.append(PQNTransition(
                obs=observation,
                action=action,
                reward=timestep.reward,
                discount=timestep.discount,
                truncated=timestep.last() & (timestep.discount != 0.0),
                next_obs=timestep.extras["next_obs"],
                info=timestep.extras["episode_metrics"],
            ))
        return state._replace(env_state=env_state, timestep=timestep), tree_stack(steps)

    @torch.no_grad()
    def targets(self, params: List[Any], traj: PQNTransition) -> torch.Tensor:
        """Q(lambda) targets [T, U.E]: each replica's Q of its envs' next
        observations, then ONE q_lambda over every column."""
        parts = [self.q_apply(p, anakin.env_group(traj.next_obs, u, self.update_batch, 1),
                              0.0).preferences for u, p in enumerate(params)]
        q_next = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
        lam_t = self.lam * (1.0 - traj.truncated.to(torch.float32))
        return q_lambda(traj.reward, self.gamma * traj.discount, q_next, lam_t,
                        batch_major=False)

    def loss(self, params: Dict[str, torch.Tensor], obs: Any, action: torch.Tensor,
             target: torch.Tensor):
        q = self.q_apply(params, obs, 0.0).preferences
        qa = torch.gather(q, -1, action.long()[..., None])[..., 0]
        loss = 0.5 * torch.mean((qa - target) ** 2)
        return loss, {"q_loss": loss.detach(), "mean_q": torch.mean(q).detach()}

    def _update_minibatch(self, params: List[Any], opt_states: List[Any], batches: List[Tuple]):
        per_replica = []
        for p, (obs, action, target) in zip(params, batches):
            with torch.enable_grad():
                leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
                loss, info = self.loss(leaves, obs, action, target)
                grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            per_replica.append((grads, info))
        grads = anakin.data_mean(anakin.mean_gradients([g[0] for g in per_replica]),
                                 self.data_group)
        info = per_replica[0][1] if len(per_replica) == 1 else tree_stack(
            [g[1] for g in per_replica])
        new_params, new_opt = [], []
        for p, (radam_state, steps) in zip(params, opt_states):
            updates, radam_state = self.optim.update(grads, radam_state)
            new_params.append(apply_updates(p, updates))
            new_opt.append((radam_state, count_gradient_steps(steps)))
        return new_params, new_opt, info

    def update(self, params: Any, opt_states: Any, traj: PQNTransition, generator: Any,
               permutations: Any = None) -> Tuple[Any, Any, Dict, torch.Tensor]:
        """Targets, then epochs x minibatches on one [T, U.E] trajectory. Each
        epoch shuffles every replica's samples with `permutations[epoch]`
        when given (a tensor at U = 1, else one a replica), else with a
        permutation drawn from the replica's generator. Returns (params,
        opt_states, loss_info, targets)."""
        replica_params = anakin.split_replicas(params, self.update_batch)
        replica_opt = anakin.split_replicas(opt_states, self.update_batch)
        generators = anakin.per_replica(generator, self.update_batch)
        targets = self.targets(replica_params, traj)
        samples = (traj.obs, traj.action, targets)
        flat = [tree_merge_leading_dims(anakin.env_group(samples, u, self.update_batch, 1), 2)
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
                replica_params, replica_opt, info = self._update_minibatch(
                    replica_params, replica_opt, batches)
                per_minibatch.append(info)
            per_epoch.append(tree_stack(per_minibatch))
        return (anakin.join_replicas(replica_params), anakin.join_replicas(replica_opt),
                tree_stack(per_epoch), targets)

    def update_step(self, state: OnPolicyLearnerState) -> Tuple[OnPolicyLearnerState, Tuple]:
        state, traj = self.rollout(state)
        params, opt_states, loss_info, _ = self.update(state.params, state.opt_states, traj,
                                                       state.generator)
        return state._replace(params=params, opt_states=opt_states), (traj.info, loss_info)

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
    """The Q-network (LayerNorm MLP by default; initialised on the CPU from
    `seed`, then moved to `device`), clip + RAdam with the step counter, the
    learner and its initial state."""
    config.system.action_dim = env.num_actions
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)
    update_batch = int(config.arch.get("update_batch_size", 1))
    q_network = build_q_network(env, config, anakin.make_generator(init_seed,
                                                                   torch.device("cpu")))
    q_network.to(device)
    q_apply = make_q_apply(q_network)
    optim = ClipRAdam(make_learning_rate(float(config.system.q_lr), config,
                                         int(config.system.epochs),
                                         int(config.system.num_minibatches)),
                      float(config.system.max_grad_norm))
    params = {k: v.detach() for k, v in q_network.named_parameters()}
    opt_state = (optim.init(params), PQNStepCount(0))
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    learner_state = OnPolicyLearnerState(
        params=anakin.broadcast_to_update_batch(params, update_batch),
        opt_states=anakin.broadcast_to_update_batch(opt_state, update_batch),
        generator=anakin.make_step_generators(step_seed, device, update_batch),
        env_state=env_state,
        timestep=timestep,
    )
    return AnakinSetup(
        learn=PQNLearner(env, q_apply, optim, config),
        learner_state=learner_state,
        eval_act_fn=get_distribution_act_fn(config, q_apply),
        eval_params_fn=lambda s: anakin.split_replicas(s.params, update_batch)[0],
    )


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin PQN; returns the final evaluation episode-return mean.
    Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_pqn.yaml", sys.argv[1:]
    )
    return run_experiment(config)


if __name__ == "__main__":
    main()
