"""Anakin PPO (counterpart of stoix_tpu/systems/ppo/anakin/ff_ppo.py on its
single-device path), the learner of the whole ff PPO family: discrete
actions from a Categorical head, or continuous ones, float [E, A], from a
continuous head (ff_ppo_continuous), carried through the rollout, the
trajectory, the minibatch gather and `log_prob` alike; the penalty and DPO
systems swap the clip objective through `policy_loss_fn`.

One update step, in the JAX package's order:

  1. rollout: `rollout_length` steps of every env (a Python loop where the
     JAX package scans), storing raw observations, actions, values and
     log-probs;
  2. with `system.normalize_observations`, the trajectory's observations
     normalised with the pre-update statistics, then the raw ones folded in;
  3. ONE batched critic pass over the [T, E] `extras["next_obs"]` for the
     bootstrap values;
  4. truncation-aware GAE, in one launch of the Hopper kernel's GAE entry
     point under `system.multistep_impl: pallas`;
  5. `epochs` times: a permutation of the T·E samples, then
     `num_minibatches` clipped-PPO updates, each an actor and a critic
     gradient pass (one joint pass under `system.fused_update`), the
     divergence guard under `system.update_guard`, and a global-norm
     clip + Adam step;
  6. with `system.adaptive_kl_beta`, β doubled or halved around
     `system.kl_target` from the KL between the rollout's policy and the
     updated one.

`arch.update_batch_size` U > 1 runs U replicas, as the JAX package's
`vmap(axis_name="batch")` does: params and optimizer states carry a leading
[U] axis, the envs split into U groups of `total_num_envs // U` (replica u
owns columns u·E to (u+1)·E of every [T, U·E] tensor), each replica samples
and shuffles from its own generator and standardises its own advantages,
and every gradient is averaged over the U replicas before the clip and Adam,
so the replicas stay identical. GAE runs once over the whole [T, U·E]
trajectory (its columns are independent): one B1 launch an update at any U.
The observation statistics and β are held once: the JAX package's psum and
pmean over "batch" make them the same on every replica.

Over N data-parallel ranks (systems/anakin.py) each rank runs this learner on
its own `total_num_envs // N` envs, and the learner reduces over the "data"
axis where the JAX learner calls `pmean` or `psum` over it: each minibatch's
gradients (after the replicas' mean, before the clip) in one flat
all-reduce, with the guard's loss in the same bucket; the observation sums;
the measured KL; and, once a window, the train metrics. Advantages stay
standardised over the rank's own batch, as inside the JAX shard.

On a mesh with a "group" axis (`arch=gossip`), `learner_setup` branches to
`grouped_learner_setup`: G gossip-averaged learner groups of ranks, each
this learner over its group's own data axis, mixed by the runner every
`arch.gossip.interval` windows (parallel/gossip.py). The ff_ppo family
(continuous, penalty, DPO) reaches it through this setup.

Population training (population/runner.py) runs this learner once a member
with `hparams`: per-member overrides of `gamma`, `reward_scale`,
`gae_lambda`, `clip_eps`, `ent_coef`, `vf_coef`, `actor_lr` and
`critic_lr`, host floats holding float32 values, as the JAX package threads
them as float32 scalars (its ff_ppo.py:85-130). A lifted learning rate is the
member's own clip + Adam at that rate: `ClipAdam` multiplies the Adam
direction by `-lr`, the JAX package's `u * (-lr)` after `scale_by_adam`.
With `hparams=None` every value is the config's, as before.

Parameters are `{name: tensor}` dicts applied with
`torch.func.functional_call`; updates build new dicts and never write in
place, so a window's eval params need no copy. No tensor of the update path
is read back to the host: the guard and β select on the device.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

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
from stoix_tpu_torch.ops import losses, running_statistics, truncated_generalized_advantage_estimation
from stoix_tpu_torch.parallel import gossip, mesh_shape, process_count, replicate
from stoix_tpu_torch.resilience import guards
from stoix_tpu_torch.systems import anakin
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam, apply_updates, make_learning_rate
from stoix_tpu_torch.utils.tree import tree_map, tree_merge_leading_dims, tree_stack


class PPOLearnerState(NamedTuple):
    params: ActorCriticParams  # every tensor [U, ...] when arch.update_batch_size U > 1
    opt_states: ActorCriticOptStates  # likewise
    generator: Any  # actions and shuffles: a torch.Generator, or a tuple of one a replica
    env_state: Any
    timestep: envs.TimeStep
    obs_stats: Any  # running_statistics.RunningStatisticsState
    kl_beta: Any  # float32 scalar tensor, the KL-penalty coefficient


class UpdateResult(NamedTuple):
    params: ActorCriticParams
    opt_states: ActorCriticOptStates
    loss_info: Dict[str, torch.Tensor]  # each [epochs, num_minibatches] (and [U] per replica)
    advantages: torch.Tensor  # [T, E]
    targets: torch.Tensor  # [T, E]
    kl_beta: Any = None  # the adapted β under system.adaptive_kl_beta, else as given


def adapt_kl_beta(kl_beta: torch.Tensor, measured_kl: torch.Tensor,
                  kl_target: float) -> torch.Tensor:
    """Adaptive-KL PPO's rule (Schulman et al. 2017 §4; the JAX package's
    ff_ppo.py:421-423): double β when the measured KL is above 1.5 times the
    target, halve it when below the target / 1.5, clip to [1e-3, 1e3]. On the
    device, with no host branch."""
    kl_beta = torch.where(measured_kl > 1.5 * kl_target, kl_beta * 2.0, kl_beta)
    kl_beta = torch.where(measured_kl < kl_target / 1.5, kl_beta / 2.0, kl_beta)
    return torch.clamp(kl_beta, 1e-3, 1e3)


def _leaf_copies(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _cat(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(list(parts), dim=dim)


def _at_learning_rate(optim: ClipAdam, lr: Optional[float]) -> ClipAdam:
    """`optim` itself, or a copy of it at the flat rate `lr` (a population
    member's lifted learning rate; population_setup refuses a schedule)."""
    if lr is None:
        return optim
    member = copy.copy(optim)
    member.learning_rate = float(lr)
    return member


class PPOLearner:
    """The learner function: `learner(state) -> ExperimentOutput` runs
    `arch.num_updates_per_eval` update steps. `rollout` and `update` are the
    two halves of one step, callable on their own.

    `policy_loss_fn(dist, action, old_log_prob, gae, config, behavior_dist=,
    beta=) -> (loss, entropy)` replaces the clip objective, as the JAX
    package's hook does; `behavior_dist` is the rollout's policy on the same
    observations. `hparams` overrides the config's `gamma`, `reward_scale`,
    `gae_lambda`, `clip_eps`, `ent_coef`, `vf_coef`, `actor_lr` and
    `critic_lr` for one population member."""

    def __init__(
        self,
        env: envs.Environment,
        apply_fns: Tuple[Callable, Callable],
        update_fns: Tuple[ClipAdam, ClipAdam],
        config: Any,
        policy_loss_fn: Optional[Callable] = None,
        hparams: Optional[Dict[str, float]] = None,
    ):
        self.env = env
        self.actor_apply, self.critic_apply = apply_fns
        hp = dict(hparams or {})
        self.actor_optim, self.critic_optim = (
            _at_learning_rate(optim, hp.get(key))
            for optim, key in zip(update_fns, ("actor_lr", "critic_lr")))
        self.config = config
        self.policy_loss_fn = policy_loss_fn
        system = config.system
        self.adaptive_kl = bool(system.get("adaptive_kl_beta", False))
        if self.adaptive_kl and not getattr(policy_loss_fn, "uses_kl_beta", False):
            # As the JAX package: adapting β for a loss that discards it would
            # log a "working" kl_beta while changing nothing.
            raise ValueError(
                "system.adaptive_kl_beta=true requires a policy loss that consumes "
                "kl_beta (the PPO-penalty loss); the configured loss does not."
            )
        self.kl_target = float(system.get("kl_target", 0.01))
        self.gamma = float(hp.get("gamma", system.gamma))
        self.reward_scale = float(hp.get("reward_scale", system.get("reward_scale", 1.0)))
        self.gae_lambda = float(hp.get("gae_lambda", system.gae_lambda))
        self.clip_eps = float(hp.get("clip_eps", system.clip_eps))
        self.ent_coef = float(hp.get("ent_coef", system.ent_coef))
        self.vf_coef = float(hp.get("vf_coef", system.vf_coef))
        self.clip_value = bool(system.get("clip_value", True))
        self.standardize_advantages = bool(system.get("standardize_advantages", True))
        self.multistep_impl = str(system.get("multistep_impl", "scan"))
        self.normalize_obs = bool(system.get("normalize_observations", False))
        self.guard_mode = guards.resolve_mode(config)
        self.fused_update = bool(system.get("fused_update", False))
        self.rollout_length = int(system.rollout_length)
        self.epochs = int(system.epochs)
        self.num_minibatches = int(system.num_minibatches)
        self.num_updates_per_eval = int(config.arch.num_updates_per_eval)
        self.update_batch = int(config.arch.get("update_batch_size", 1))
        self.data_group = anakin.data_group()

    # ------------------------------------------------------------ replicas

    def replicas(self, tree: Any) -> List[Any]:
        """The U replicas of a [U]-leading tree (the tree itself at U = 1)."""
        return anakin.split_replicas(tree, self.update_batch)

    def join(self, trees: Sequence[Any]) -> Any:
        """The inverse of `replicas`."""
        return anakin.join_replicas(trees)

    def generators(self, generator: Any) -> List[Optional[torch.Generator]]:
        if generator is None:
            return [None] * self.update_batch
        return anakin.per_replica(generator, self.update_batch)

    def group(self, tree: Any, index: int, dim: int) -> Any:
        """Replica `index`'s env columns of every tensor (envs along `dim`)."""
        return anakin.env_group(tree, index, self.update_batch, dim)

    def eval_params(self, params: ActorCriticParams) -> Dict[str, torch.Tensor]:
        """Replica 0's actor params, which the evaluator takes."""
        return self.replicas(params)[0].actor_params

    # ------------------------------------------------------------ rollout

    def normalized(self, observation: Any, obs_stats: Any) -> Any:
        if not self.normalize_obs:
            return observation
        return running_statistics.normalize_observation(observation, obs_stats)

    def act(self, params: List[ActorCriticParams], generators: Sequence[Any],
            inputs: Any) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Each replica's policy and value on its group of envs; the action
        drawn from its generator. Returns action, value, log-prob over every env."""
        outs = []
        for u, (p, generator) in enumerate(zip(params, generators)):
            x = self.group(inputs, u, 0)
            policy = self.actor_apply(p.actor_params, x)
            value = self.critic_apply(p.critic_params, x)
            action = policy.sample(generator)
            outs.append((action, value, policy.log_prob(action)))
        return tuple(_cat(parts, 0) for parts in zip(*outs))

    @torch.no_grad()
    def rollout(self, state: PPOLearnerState) -> Tuple[PPOLearnerState, PPOTransition]:
        """`rollout_length` env steps; the transitions stacked to [T, E, ...],
        observations raw."""
        params, generators = self.replicas(state.params), self.generators(state.generator)
        env_state, timestep = state.env_state, state.timestep
        transitions = []
        for _ in range(self.rollout_length):
            observation = timestep.observation
            action, value, log_prob = self.act(
                params, generators, self.normalized(observation, state.obs_stats))
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

    def policy_input(self, traj_batch: Any) -> Any:
        """What the actor and critic saw at each step of a [T, E] trajectory."""
        return traj_batch.obs

    def bootstrap_input(self, traj_batch: Any) -> Any:
        """What the critic reads for the bootstrap values v_t."""
        return traj_batch.next_obs

    def loss_info(
        self, loss_actor: torch.Tensor, value_loss: torch.Tensor, entropy: torch.Tensor
    ) -> Dict[str, torch.Tensor]:
        """The train metrics of one minibatch, under the JAX system's names."""
        return {
            "total_loss": loss_actor + value_loss,
            "actor_loss": loss_actor,
            "value_loss": value_loss,
            "entropy": entropy,
        }

    # ------------------------------------------------------------ update

    def actor_loss(self, actor_params, behavior_params, obs, action, old_log_prob, advantages,
                   kl_beta):
        """(actor total, actor loss, entropy), as the JAX `_actor_loss_fn`."""
        policy = self.actor_apply(actor_params, obs)
        if self.policy_loss_fn is not None:
            with torch.no_grad():
                behavior = self.actor_apply(behavior_params, obs)
            loss_actor, entropy = self.policy_loss_fn(
                policy, action, old_log_prob, advantages, self.config,
                behavior_dist=behavior, beta=kl_beta,
            )
        else:
            loss_actor = losses.ppo_clip_loss(
                policy.log_prob(action), old_log_prob, advantages, self.clip_eps
            )
            entropy = policy.entropy().mean()
        return loss_actor - self.ent_coef * entropy, loss_actor, entropy

    def critic_loss(self, critic_params, obs, targets, old_value) -> torch.Tensor:
        value = self.critic_apply(critic_params, obs)
        if self.clip_value:
            return losses.clipped_value_loss(value, old_value, targets, self.clip_eps)
        return torch.mean((value - targets) ** 2)

    def gradients(self, params: ActorCriticParams, batch: Tuple, behavior_params: Any,
                  kl_beta: Any):
        """One replica's actor and critic gradients on one minibatch: two
        backward passes, or one over the joint loss under `fused_update` (the
        losses share no parameters, so the gradients are the same)."""
        obs, action, old_log_prob, old_value, advantages, targets = batch
        with torch.enable_grad():
            actor_params = _leaf_copies(params.actor_params)
            actor_total, loss_actor, entropy = self.actor_loss(
                actor_params, behavior_params, obs, action, old_log_prob, advantages, kl_beta)
            if not self.fused_update:
                actor_grads = dict(
                    zip(actor_params, torch.autograd.grad(actor_total,
                                                          list(actor_params.values())))
                )
            critic_params = _leaf_copies(params.critic_params)
            value_loss = self.critic_loss(critic_params, obs, targets, old_value)
            if self.fused_update:
                leaves = list(actor_params.values()) + list(critic_params.values())
                joint = torch.autograd.grad(actor_total + self.vf_coef * value_loss, leaves)
                actor_grads = dict(zip(actor_params, joint[:len(actor_params)]))
                critic_grads = dict(zip(critic_params, joint[len(actor_params):]))
            else:
                critic_grads = dict(
                    zip(critic_params,
                        torch.autograd.grad(self.vf_coef * value_loss,
                                            list(critic_params.values())))
                )
        return actor_grads, critic_grads, (loss_actor.detach(), value_loss.detach(),
                                           entropy.detach())

    def _update_minibatch(self, params: List[ActorCriticParams],
                          opt_states: List[ActorCriticOptStates], batches: Sequence[Tuple],
                          behavior: Sequence[Any], kl_beta: Any):
        """One minibatch update of every replica: the replicas' gradients
        averaged, then over the data ranks, then each replica's clip + Adam
        step, then the guard."""
        per_replica = [self.gradients(p, batch, b, kl_beta)
                       for p, batch, b in zip(params, batches, behavior)]
        actor_grads, critic_grads = (anakin.mean_gradients([g[side] for g in per_replica])
                                     for side in (0, 1))
        if len(per_replica) == 1:
            terms = per_replica[0][2]
        else:
            terms = tuple(torch.stack(parts) for parts in zip(*(g[2] for g in per_replica)))
        guard = guards.active(self.guard_mode)
        guard_loss = None
        if guard:  # off (and no fault armed) adds no op
            guard_loss = (terms[0] + terms[1]).mean()
        actor_grads, critic_grads, guard_loss = anakin.data_mean(
            (actor_grads, critic_grads, guard_loss), self.data_group)
        new_params, new_opt = [], []
        for p, opt in zip(params, opt_states):
            actor_updates, actor_opt_state = self.actor_optim.update(
                actor_grads, opt.actor_opt_state)
            critic_updates, critic_opt_state = self.critic_optim.update(
                critic_grads, opt.critic_opt_state)
            new_params.append(ActorCriticParams(
                apply_updates(p.actor_params, actor_updates),
                apply_updates(p.critic_params, critic_updates),
            ))
            new_opt.append(ActorCriticOptStates(actor_opt_state, critic_opt_state))
        loss_actor, value_loss, entropy = terms
        info = self.loss_info(loss_actor, value_loss, entropy)
        if guard:
            (new_params, new_opt), guard_metrics = guards.guard_update(
                self.guard_mode, new=(new_params, new_opt), old=(params, opt_states),
                loss=guard_loss, grads=(actor_grads, critic_grads), opt_state=opt_states,
            )
            info.update(guard_metrics)
        return new_params, new_opt, info

    def standardized(self, advantages: torch.Tensor) -> torch.Tensor:
        """Each replica's advantages standardised over its own [T, E] batch
        (population std, as jnp.std)."""
        t_len, n = advantages.shape[:2]
        per = advantages.reshape(t_len, self.update_batch, n // self.update_batch)
        mean = per.mean(dim=(0, 2), keepdim=True)
        std = per.std(dim=(0, 2), correction=0, keepdim=True)
        return ((per - mean) / (std + 1e-8)).reshape(advantages.shape)

    def measured_kl(self, behavior: Any, params: ActorCriticParams, obs: Any,
                    traj_batch: Any) -> torch.Tensor:
        """KL(behavior || updated policy) over one replica's rollout batch, or
        the JAX package's k3 estimate exp(r) - 1 - r of the clamped log-ratio
        where the distribution has no analytic KL (its `kl_divergence`
        raises NotImplementedError: TanhNormal, Beta)."""
        new_dist = self.actor_apply(params.actor_params, obs)
        behavior_dist = self.actor_apply(behavior, obs)
        try:
            return torch.mean(behavior_dist.kl_divergence(new_dist))
        except NotImplementedError:
            log_ratio = torch.clamp(
                new_dist.log_prob(traj_batch.action) - traj_batch.log_prob,
                -losses._LOG_RATIO_CLAMP, losses._LOG_RATIO_CLAMP,
            )
            return torch.mean(torch.exp(log_ratio) - 1.0 - log_ratio)

    def update(
        self,
        params: ActorCriticParams,
        opt_states: ActorCriticOptStates,
        traj_batch: Any,
        generator: Any = None,
        permutations: Optional[Sequence[Any]] = None,
        kl_beta: Any = None,
    ) -> UpdateResult:
        """Bootstrap values, GAE, then epochs × minibatches of PPO updates on
        one [T, E] trajectory (observations as the networks take them). Each
        epoch shuffles every replica's T·E samples with `permutations[epoch]`
        when given (a tensor at U = 1, else one a replica), else with a
        permutation drawn from the replica's generator."""
        replica_params, replica_opt = self.replicas(params), self.replicas(opt_states)
        generators = self.generators(generator)
        with torch.no_grad():
            boot = self.bootstrap_input(traj_batch)
            v_t = _cat([self.critic_apply(p.critic_params, self.group(boot, u, 1))
                        for u, p in enumerate(replica_params)], 1)
            d_t = self.gamma * (1.0 - traj_batch.done.to(torch.float32))
            advantages, targets = truncated_generalized_advantage_estimation(
                traj_batch.reward * self.reward_scale,
                d_t,
                self.gae_lambda,
                v_tm1=traj_batch.value,
                v_t=v_t,
                truncation_t=traj_batch.truncated.to(torch.float32),
                standardize_advantages=self.standardize_advantages and self.update_batch == 1,
                impl=self.multistep_impl,
            )
            if self.standardize_advantages and self.update_batch > 1:
                advantages = self.standardized(advantages)

        samples = (
            self.policy_input(traj_batch), traj_batch.action, traj_batch.log_prob,
            traj_batch.value, advantages, targets,
        )
        flat = [tree_merge_leading_dims(self.group(samples, u, 1), 2)
                for u in range(self.update_batch)]
        batch_size = advantages.numel() // self.update_batch
        # The rollout's actor params: the anchor of a KL penalty, fixed across epochs.
        behavior = [p.actor_params for p in replica_params]
        per_epoch = []
        for epoch in range(self.epochs):
            minibatches = []
            for u in range(self.update_batch):
                if permutations is not None:
                    given = permutations[epoch]
                    permutation = (given if self.update_batch == 1 else given[u]).to(
                        advantages.device)
                else:
                    permutation = torch.randperm(
                        batch_size, generator=generators[u], device=advantages.device
                    )
                minibatches.append(tree_map(
                    lambda x: x.index_select(0, permutation).reshape(
                        (self.num_minibatches, -1) + x.shape[1:]
                    ),
                    flat[u],
                ))
            per_minibatch = []
            for i in range(self.num_minibatches):
                batches = [tree_map(lambda x: x[i], mb) for mb in minibatches]
                replica_params, replica_opt, loss_info = self._update_minibatch(
                    replica_params, replica_opt, batches, behavior, kl_beta)
                per_minibatch.append(loss_info)
            per_epoch.append(tree_stack(per_minibatch))
        loss_info = tree_stack(per_epoch)

        if self.adaptive_kl:
            with torch.no_grad():
                obs = self.policy_input(traj_batch)
                measured = torch.stack([
                    self.measured_kl(b, p, self.group(obs, u, 1), self.group(traj_batch, u, 1))
                    for u, (b, p) in enumerate(zip(behavior, replica_params))
                ]).mean()
                measured = anakin.data_mean(measured, self.data_group, kind="kl")
                kl_beta = adapt_kl_beta(kl_beta, measured, self.kl_target)
            loss_info = {**loss_info, "measured_kl": measured, "kl_beta": kl_beta}
        return UpdateResult(self.join(replica_params), self.join(replica_opt), loss_info,
                            advantages, targets, kl_beta)

    def folded_statistics(self, stats: Any, raw: Any) -> Any:
        """The observation statistics with a [T, U.E] trajectory's raw
        observations folded in, summed over the replicas and then the data
        ranks (the JAX package's psum over ("batch", "data"))."""
        view = raw.agent_view
        replica_axis = None
        if self.update_batch > 1:
            view = view.reshape(view.shape[:1] + (self.update_batch, -1) + view.shape[2:])
            replica_axis = 1
        return running_statistics.update(stats, view, replica_axis=replica_axis,
                                         group=self.data_group,
                                         std_min_value=5e-4, std_max_value=5e4)

    def update_step(
        self, state: PPOLearnerState
    ) -> Tuple[PPOLearnerState, Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
        state, traj_batch = self.rollout(state)
        if self.normalize_obs:
            # Normalise with the PRE-update statistics (what the rollout's
            # log-probs and values used), THEN fold the raw observations in,
            # summed over the replicas (ff_ppo.py:355-372 of the JAX package).
            stats, raw = state.obs_stats, traj_batch.obs
            traj_batch = traj_batch._replace(
                obs=running_statistics.normalize_observation(raw, stats),
                next_obs=running_statistics.normalize_observation(traj_batch.next_obs, stats),
            )
            state = state._replace(obs_stats=self.folded_statistics(stats, raw))
        result = self.update(state.params, state.opt_states, traj_batch, state.generator,
                             kl_beta=getattr(state, "kl_beta", None))
        state = state._replace(params=result.params, opt_states=result.opt_states)
        if self.adaptive_kl:
            state = state._replace(kl_beta=result.kl_beta)
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
            # The ranks' means, so every rank's host reads the same metrics.
            train_metrics=anakin.data_mean(tree_stack(loss_info), self.data_group,
                                           kind="metrics"),
        )


def get_learner_fn(
    env: envs.Environment,
    apply_fns: Tuple[Callable, Callable],
    update_fns: Tuple[ClipAdam, ClipAdam],
    config: Any,
    policy_loss_fn: Optional[Callable] = None,
    hparams: Optional[Dict[str, float]] = None,
) -> PPOLearner:
    """The learner; `hparams` (a population member's lifted scalars, host
    floats) overrides the config's, None keeps the config's."""
    return PPOLearner(env, apply_fns, update_fns, config, policy_loss_fn, hparams)


def make_apply_fn(network: torch.nn.Module) -> Callable[[Dict[str, torch.Tensor], Any], Any]:
    """`apply(params, observation)`: the network with `params` swapped in."""
    return lambda params, observation: functional_call(network, params, (observation,))


def _build(env: envs.Environment, cfg: Any, head_key: str, head_kwargs: dict,
           generator: torch.Generator):
    """(head, torso, input layer) of one network config, each module taking
    its input size from the one before it."""
    input_layer = config_lib.instantiate(cfg.input_layer)
    torso = config_lib.instantiate(
        cfg.pre_torso, generator=generator,
        **anakin.torso_input_kwargs(cfg.pre_torso, input_layer(env.observation_value())))
    head = config_lib.instantiate(
        cfg[head_key], input_dim=torso.output_dim, generator=generator, **head_kwargs
    )
    return head, torso, input_layer


def build_actor(env: envs.Environment, config: Any, generator: torch.Generator):
    """The FeedForwardActor of `network.actor_network`, its head taking the
    env's action space; the weights draw from `generator`."""
    from stoix_tpu_torch.networks.base import FeedForwardActor

    actor_cfg = config.network.actor_network
    return FeedForwardActor(*_build(env, actor_cfg, "action_head",
                                    anakin.head_kwargs_for_env(actor_cfg.action_head, env),
                                    generator))


def build_networks(env: envs.Environment, config: Any, generator: torch.Generator):
    """Actor/critic construction from the network config; the weights draw
    from `generator`, the actor's first."""
    from stoix_tpu_torch.networks.base import FeedForwardCritic

    actor_network = build_actor(env, config, generator)
    critic_network = FeedForwardCritic(*_build(env, config.network.critic_network,
                                               "critic_head", {}, generator))
    return actor_network, critic_network


def make_optimizers(config: Any) -> Tuple[ClipAdam, ClipAdam]:
    """The actor's and the critic's clip + Adam."""
    epochs, num_minibatches = int(config.system.epochs), int(config.system.num_minibatches)
    max_grad_norm = float(config.system.max_grad_norm)
    return tuple(
        ClipAdam(make_learning_rate(float(config.system[key]), config, epochs, num_minibatches),
                 max_grad_norm, eps=1e-5)
        for key in ("actor_lr", "critic_lr")
    )


def initial_train_state(
    actor_network: torch.nn.Module, critic_network: torch.nn.Module,
    optims: Tuple[ClipAdam, ClipAdam], config: Any, device: torch.device, step_seed: int,
) -> Tuple[ActorCriticParams, ActorCriticOptStates, Any]:
    """Params, optimizer states and the step generator(s): unbatched at
    U = 1; with a leading [U] axis (U identical copies) and one generator a
    replica past it."""
    params = ActorCriticParams(
        {k: v.detach() for k, v in actor_network.named_parameters()},
        {k: v.detach() for k, v in critic_network.named_parameters()},
    )
    opt_states = ActorCriticOptStates(optims[0].init(params.actor_params),
                                      optims[1].init(params.critic_params))
    update_batch = int(config.arch.get("update_batch_size", 1))
    return (anakin.broadcast_to_update_batch(params, update_batch),
            anakin.broadcast_to_update_batch(opt_states, update_batch),
            anakin.make_step_generators(step_seed, device, update_batch))


def learner_setup(
    env: envs.Environment, config: Any, device: torch.device, seed: int,
    policy_loss_fn: Optional[Callable] = None,
) -> AnakinSetup:
    """Build the networks (initialised on the CPU from `seed`, then moved to
    `device`), the optimizers, the learner and its initial state. On a mesh
    with a "group" axis, `grouped_learner_setup` instead, as the JAX
    package's learner_setup branches."""
    if "group" in (config.arch.get("mesh") or {}):
        return grouped_learner_setup(env, config, device, seed, policy_loss_fn)
    return _setup(env, config, device, anakin.make_seeds(seed, 3), policy_loss_fn)


def _setup(env: envs.Environment, config: Any, device: torch.device, seeds: Sequence[int],
           policy_loss_fn: Optional[Callable], group_zero_params: bool = False) -> AnakinSetup:
    """The setup from (init, env, step) seeds. With `group_zero_params` the
    evaluator takes learner group 0's actor params (and statistics), which
    every rank receives by a broadcast over the "group" axis."""
    config.system.action_dim = env.num_actions
    init_seed, env_seed, step_seed = seeds

    actor_network, critic_network = build_networks(
        env, config, anakin.make_generator(init_seed, torch.device("cpu"))
    )
    actor_network.to(device)
    critic_network.to(device)
    optims = make_optimizers(config)
    actor_apply, critic_apply = make_apply_fn(actor_network), make_apply_fn(critic_network)
    learner = get_learner_fn(env, (actor_apply, critic_apply), optims, config, policy_loss_fn)
    params, opt_states, generator = initial_train_state(
        actor_network, critic_network, optims, config, device, step_seed)

    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device)
    )
    learner_state = PPOLearnerState(
        params=params,
        opt_states=opt_states,
        generator=generator,
        env_state=env_state,
        timestep=timestep,
        obs_stats=running_statistics.init_state(
            env.observation_value().agent_view.to(device)),
        # 3.0, the penalty loss's default, keeps a KL penalty active when the
        # config names no kl_beta; the clip loss never reads it.
        kl_beta=torch.tensor(float(config.system.get("kl_beta", 3.0)), device=device),
    )
    mesh = anakin.grouped_mesh() if group_zero_params else None
    if mesh is not None and anakin.group_rank_and_size()[1] > 1:
        def from_group_zero(tree: Any) -> Any:
            return replicate(tree, mesh, axis="group")
    else:
        def from_group_zero(tree: Any) -> Any:
            return tree
    if learner.normalize_obs:
        # The evaluator takes replica 0's actor params with the statistics.
        def eval_apply(bundle, observation):
            actor_params, stats = bundle
            return actor_apply(actor_params,
                               running_statistics.normalize_observation(observation, stats))

        eval_act_fn = get_distribution_act_fn(config, eval_apply)
        eval_params_fn = lambda s: from_group_zero(  # noqa: E731
            (learner.eval_params(s.params), s.obs_stats))
    else:
        eval_act_fn = get_distribution_act_fn(config, actor_apply)
        eval_params_fn = lambda s: from_group_zero(learner.eval_params(s.params))  # noqa: E731
    return AnakinSetup(
        learn=learner,
        learner_state=learner_state,
        eval_act_fn=eval_act_fn,
        eval_params_fn=eval_params_fn,
        guarded=True,
    )


def grouped_learner_setup(
    env: envs.Environment, config: Any, device: torch.device, seed: int,
    policy_loss_fn: Optional[Callable] = None,
) -> AnakinSetup:
    """G gossip-averaged learner groups on a ("group", "data") mesh
    (parallel/gossip.py; the JAX package's ff_ppo.py:592-760).

    Each group is the unchanged learner: its "data" collectives run over its
    own data subgroup (systems/anakin.py::data_group), so the gradient
    all-reduce never crosses a group boundary. Every group starts from group
    0's params and optimizer state (the init draws from the run's init seed
    on every rank), and rolls out on its own env and step streams: group g
    takes `anakin.group_member_seed(seed, g)`, split into (init, env, step)
    seeds as the plain run splits `seed`, of which it keeps env and step.
    Group 0's seeds are exactly the plain run's, so one group is the plain
    run, bit for bit. Env counts are per group. The evaluator serves group
    0's params; the runner mixes the groups every `arch.gossip.interval`
    windows through the returned plan."""
    mesh = anakin.grouped_mesh()
    axes = mesh if mesh is not None else mesh_shape(dict(config.arch.mesh), process_count())
    gossip.validate_grouped_config(config, axes)
    group, _ = anakin.group_rank_and_size()
    init_seed = anakin.make_seeds(seed, 3)[0]
    _, env_seed, step_seed = anakin.make_seeds(anakin.group_member_seed(seed, group), 3)
    setup = _setup(env, config, device, (init_seed, env_seed, step_seed), policy_loss_fn,
                   group_zero_params=True)
    return setup._replace(gossip=gossip.build_gossip_plan(config, axes))


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin PPO; returns the final evaluation episode-return mean.
    Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device, outer_axes=("group",))


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_ppo.yaml", sys.argv[1:]
    )
    return run_experiment(config)


if __name__ == "__main__":
    main()
