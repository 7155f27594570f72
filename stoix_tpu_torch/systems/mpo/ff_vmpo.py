"""Anakin V-MPO (counterpart of stoix_tpu/systems/mpo/ff_vmpo.py), the
learner of ff_vmpo and ff_vmpo_continuous (the continuous head comes from
the network config), and the dual helpers ff_mpo shares.

On-policy MPO: the E-step reweights the TOP HALF of the advantages through a
learned temperature eta, and the M-step maximises the weighted
log-likelihood under a KL trust region held by a learned alpha (decoupled
per-dimension mean and stddev alphas [2, A] for a Gaussian policy). One
update step, in the JAX package's order (ff_vmpo.py:156-331):

  1. rollout: `rollout_length` steps of every env, the TARGET actor acting
     from the replica's generator; each step stores obs, action, reward,
     discount, truncation, next_obs and the episode info;
  2. `epochs` full-batch epochs over the same [T, E] trajectory, each:
     the critic's values of obs and next_obs (no gradient), truncated GAE
     over every replica's [T, E_u] in ONE call (one launch of B1's GAE entry
     under `system.multistep_impl: pallas`); then each replica's losses at
     the same pre-update params: the top half of its own T . E_u advantages
     (a stable descending sort, as `jnp.argsort`), eta's dual loss, the
     weighted max-likelihood, the KL(target || online) penalty and alpha's
     dual loss, and the critic's 0.5 mean((V - G)^2); the actor's, the
     duals' and the critic's gradients averaged over the replicas, then the
     data ranks, in one all-reduce; clip + Adam steps of the actor and
     critic, plain Adam (eps 1e-8) of the duals, the duals floored at -18;
     the step count advanced and the target actor set to the NEW online
     actor where it is a multiple of `actor_target_period`;
  3. the update's metrics are its last epoch's.

The step count is a host int in `VMPOParams.step_count`, the same on every
rank and replica, so the periodic refresh reads no device value and a
checkpoint carries it. The JAX ff_vmpo does not read `system.update_guard`;
the port refuses it (ROADMAP C19).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ExperimentOutput, OnlineAndTarget, OnPolicyLearnerState
from stoix_tpu_torch.envs import spaces
from stoix_tpu_torch.evaluator import get_distribution_act_fn
from stoix_tpu_torch.ops import distributions as dists
from stoix_tpu_torch.ops import truncated_generalized_advantage_estimation
from stoix_tpu_torch.systems import anakin, off_policy_core as core
from stoix_tpu_torch.systems.ddpg.ff_ddpg import join_metrics, refuse_ignored_knobs
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import _cat
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam, apply_updates, make_learning_rate
from stoix_tpu_torch.utils.tree import tree_merge_leading_dims, tree_stack

LOG_TEMPERATURE, LOG_ALPHA = "log_temperature", "log_alpha"


class VMPOParams(NamedTuple):
    actor_params: OnlineAndTarget  # acting and the KL anchor use .target
    critic_params: Dict[str, torch.Tensor]
    log_temperature: torch.Tensor  # eta's dual, a float32 scalar
    log_alpha: torch.Tensor  # the KL dual: a scalar (categorical) or [2, A] (Gaussian)
    step_count: int  # SGD steps taken (a host int; the JAX package's int32 scalar)


class VMPOOptStates(NamedTuple):
    actor_opt_state: Any
    critic_opt_state: Any
    dual_opt_state: Any  # plain Adam over {log_temperature, log_alpha}


# ---------------------------------------------------------------- the dual helpers


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return dists.softplus(x) + 1e-8


# Duals live in softplus space; the floor keeps softplus from underflowing
# so far that a dual can never recover.
_MIN_LOG_DUAL = -18.0


def project_duals(log_temperature: torch.Tensor, log_alpha: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.clamp(log_temperature, min=_MIN_LOG_DUAL),
            torch.clamp(log_alpha, min=_MIN_LOG_DUAL))


def gaussian_params(dist: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loc, scale) of the underlying diagonal Gaussian: a
    MultivariateNormalDiag's, or the pre-tanh Normal's of an
    Independent(TanhNormal)."""
    if hasattr(dist, "scale_diag"):
        return dist.loc, dist.scale_diag
    inner = getattr(dist, "distribution", dist)
    if hasattr(inner, "base"):
        return inner.base.loc, inner.base.scale
    return inner.loc, inner.scale


def gaussian_kls_per_dim(b_loc: torch.Tensor, b_scale: torch.Tensor, o_loc: torch.Tensor,
                         o_scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoupled per-dimension KL(behaviour || online) of diagonal Gaussians:
    the mean's with the stddev held at the behaviour's, the stddev's with
    the mean held; each averaged over every axis but the last, [A]."""
    kl_mean = 0.5 * torch.square((o_loc - b_loc) / b_scale)
    kl_std = torch.log(o_scale / b_scale) + 0.5 * torch.square(b_scale / o_scale) - 0.5
    dims = tuple(range(kl_mean.dim() - 1))
    return torch.mean(kl_mean, dim=dims), torch.mean(kl_std, dim=dims)


def decomposed_dists(target_dist: Any, online_dist: Any) -> Tuple[Any, Any]:
    """(fixed_stddev, fixed_mean): the online Gaussian with the TARGET's
    stddev and with the TARGET's mean, in the policy's family (a squashed
    TanhNormal on the same [minimum, maximum], or a diagonal Gaussian)."""
    b_loc, b_scale = gaussian_params(target_dist)
    o_loc, o_scale = gaussian_params(online_dist)
    inner = getattr(target_dist, "distribution", target_dist)
    if hasattr(inner, "base"):
        minimum = inner._shift - inner._scale
        maximum = inner._shift + inner._scale
        return (dists.Independent(dists.TanhNormal(o_loc, b_scale, minimum, maximum), 1),
                dists.Independent(dists.TanhNormal(b_loc, o_scale, minimum, maximum), 1))
    return (dists.MultivariateNormalDiag(o_loc, b_scale),
            dists.MultivariateNormalDiag(b_loc, o_scale))


def init_log_duals(config: Any, continuous: bool, act_dim: int, device: Any = "cpu"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_temperature, log_alpha) as float32: a continuous policy gets
    per-dimension alphas [2, A] (row 0 the mean's, row 1 the stddev's)."""
    system = config.system
    log_temperature = torch.tensor(
        float(system.get("init_log_temperature", 10.0 if continuous else 3.0)),
        dtype=torch.float32, device=device)
    if continuous:
        init_mean = float(system.get("init_log_alpha_mean", system.get("init_log_alpha", 10.0)))
        init_std = float(system.get("init_log_alpha_stddev", 500.0))
        log_alpha = torch.stack([torch.full((act_dim,), init_mean, device=device),
                                 torch.full((act_dim,), init_std, device=device)])
    else:
        log_alpha = torch.tensor(float(system.get("init_log_alpha", 3.0)), dtype=torch.float32,
                                 device=device)
    return log_temperature, log_alpha


def decoupled_alpha_losses(log_alpha: torch.Tensor, kl_mean: torch.Tensor, kl_std: torch.Tensor,
                           eps_mean: float, eps_std: float):
    """(alpha_loss, kl_loss, kl metric) of per-dimension alphas [2, A]."""
    alpha_mean, alpha_std = _softplus(log_alpha[0]), _softplus(log_alpha[1])
    alpha_loss = (torch.sum(alpha_mean * (eps_mean - kl_mean.detach()))
                  + torch.sum(alpha_std * (eps_std - kl_std.detach())))
    kl_loss = torch.sum(alpha_mean.detach() * kl_mean) + torch.sum(alpha_std.detach() * kl_std)
    return alpha_loss, kl_loss, torch.sum(kl_mean) + torch.sum(kl_std)


def categorical_alpha_losses(log_alpha: torch.Tensor, kl: torch.Tensor, eps_alpha: float):
    """(alpha_loss, kl_loss, kl metric) of a categorical policy's one alpha."""
    alpha = _softplus(log_alpha)
    return (torch.sum(alpha * (eps_alpha - kl.detach())), torch.sum(alpha.detach() * kl), kl)


def dual_params(log_temperature: torch.Tensor, log_alpha: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {LOG_TEMPERATURE: log_temperature, LOG_ALPHA: log_alpha}


def split_learnable(learnable: Dict[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(actor params, duals) of one gradient dict over both."""
    duals = {k: learnable[k] for k in (LOG_TEMPERATURE, LOG_ALPHA)}
    return {k: v for k, v in learnable.items() if k not in duals}, duals


def make_dual_optimizer(config: Any) -> ClipAdam:
    """`optax.adam(dual_lr)`: eps 1e-8, no clip, a constant rate."""
    return ClipAdam(float(config.system.get("dual_lr", 1e-2)), None, eps=1e-8)


def top_half(advantages: torch.Tensor) -> torch.Tensor:
    """The indices of the n // 2 largest of a flat advantage vector, largest
    first, equal values in index order (`jnp.argsort(-adv)[:k]`, stable)."""
    return torch.argsort(-advantages, stable=True)[:advantages.shape[0] // 2]


# ---------------------------------------------------------------- the learner


class VMPOLearner:
    """`learner(state) -> ExperimentOutput` runs `arch.num_updates_per_eval`
    update steps; `rollout`, `epoch` and `update` are its parts."""

    def __init__(self, env: envs.Environment, apply_fns: Tuple[Callable, Callable],
                 optims: Tuple[ClipAdam, ClipAdam, ClipAdam], config: Any, continuous: bool):
        self.env = env
        self.actor_apply, self.critic_apply = apply_fns
        self.actor_optim, self.critic_optim, self.dual_optim = optims
        self.continuous = continuous
        system = config.system
        self.gamma = float(system.gamma)
        self.gae_lambda = float(system.get("gae_lambda", 0.95))
        self.eps_eta = float(system.get("epsilon_eta", 0.5))
        self.eps_alpha = float(system.get("epsilon_alpha", 0.001))
        self.eps_alpha_mean = float(system.get("epsilon_alpha_mean", 0.0075))
        self.eps_alpha_stddev = float(system.get("epsilon_alpha_stddev", 1e-5))
        self.target_period = int(system.get("actor_target_period", 50))
        self.multistep_impl = str(system.get("multistep_impl", "scan"))
        self.rollout_length = int(system.rollout_length)
        self.epochs = int(system.get("epochs", 1))
        self.num_updates_per_eval = int(config.arch.num_updates_per_eval)
        self.update_batch = int(config.arch.get("update_batch_size", 1))
        self.data_group = anakin.data_group()

    def group(self, tree: Any, index: int, dim: int) -> Any:
        return anakin.env_group(tree, index, self.update_batch, dim)

    @torch.no_grad()
    def rollout(self, state: OnPolicyLearnerState) -> Tuple[OnPolicyLearnerState, Dict]:
        """`rollout_length` env steps, each replica's TARGET actor acting; the
        steps stacked to [T, E, ...]."""
        params = anakin.split_replicas(state.params, self.update_batch)
        generators = anakin.per_replica(state.generator, self.update_batch)
        env_state, timestep = state.env_state, state.timestep
        steps = []
        for _ in range(self.rollout_length):
            observation = timestep.observation
            action = _cat([self.actor_apply(p.actor_params.target, self.group(observation, u, 0))
                           .sample(g) for u, (p, g) in enumerate(zip(params, generators))], 0)
            env_state, timestep = self.env.step(env_state, action)
            steps.append({
                "obs": observation,
                "action": action,
                "reward": timestep.reward,
                "discount": timestep.discount,
                "truncated": timestep.last() & (timestep.discount != 0.0),
                "next_obs": timestep.extras["next_obs"],
                "info": timestep.extras["episode_metrics"],
            })
        return state._replace(env_state=env_state, timestep=timestep), tree_stack(steps)

    def advantages(self, params: List[VMPOParams], traj: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """(advantages, targets) over [T, U.E] from the critics' values, each
        replica's on its envs, through ONE truncated GAE call."""
        with torch.no_grad():
            v_tm1 = _cat([self.critic_apply(p.critic_params, self.group(traj["obs"], u, 1))
                          for u, p in enumerate(params)], 1)
            v_t = _cat([self.critic_apply(p.critic_params, self.group(traj["next_obs"], u, 1))
                        for u, p in enumerate(params)], 1)
            return truncated_generalized_advantage_estimation(
                traj["reward"], self.gamma * traj["discount"], self.gae_lambda, v_tm1=v_tm1,
                v_t=v_t, truncation_t=traj["truncated"].to(torch.float32),
                impl=self.multistep_impl)

    def policy_loss(self, learnable: Dict[str, torch.Tensor], target_params, obs: Any,
                    action: torch.Tensor, advantages: torch.Tensor):
        """One replica's E-step, M-step and dual losses on its flat [T.E]
        batch (ff_vmpo.py:176-241)."""
        actor_params, duals = split_learnable(learnable)
        eta = _softplus(duals[LOG_TEMPERATURE])
        dist = self.actor_apply(actor_params, obs)
        with torch.no_grad():
            target_dist = self.actor_apply(target_params, obs)
        log_prob = dist.log_prob(action)

        top = top_half(advantages)
        logw = advantages[top] / eta
        weights = torch.softmax(logw, dim=0)
        temperature_loss = eta * self.eps_eta + eta * (
            torch.logsumexp(logw, dim=0) - math.log(top.shape[0]))
        policy_loss = -torch.sum(weights.detach() * log_prob[top])

        if self.continuous:
            kl_mean, kl_std = gaussian_kls_per_dim(*gaussian_params(target_dist),
                                                   *gaussian_params(dist))
            alpha_loss, kl_loss, kl_metric = decoupled_alpha_losses(
                duals[LOG_ALPHA], kl_mean, kl_std, self.eps_alpha_mean, self.eps_alpha_stddev)
        else:
            kl = torch.mean(dists.Categorical(target_dist.logits).kl_divergence(dist))
            alpha_loss, kl_loss, kl_metric = categorical_alpha_losses(duals[LOG_ALPHA], kl,
                                                                      self.eps_alpha)
        total = policy_loss + temperature_loss + alpha_loss + kl_loss
        return total, {"policy_loss": policy_loss, "temperature": eta, "kl": kl_metric}

    def critic_loss(self, critic_params, obs: Any, targets: torch.Tensor):
        loss = 0.5 * torch.mean((self.critic_apply(critic_params, obs) - targets) ** 2)
        return loss, {"value_loss": loss}

    def epoch(self, params: List[VMPOParams], opt_states: List[VMPOOptStates], traj: Dict
              ) -> Tuple[List[VMPOParams], List[VMPOOptStates], Dict[str, torch.Tensor]]:
        """One full-batch epoch of every replica (ff_vmpo.py:243-301)."""
        advantages, targets = self.advantages(params, traj)
        actor_grads, dual_grads, critic_grads, metrics = [], [], [], []
        for u, p in enumerate(params):
            obs, action, adv = (tree_merge_leading_dims(self.group(x, u, 1), 2)
                                for x in (traj["obs"], traj["action"], advantages))
            learnable = {**p.actor_params.online, **dual_params(p.log_temperature, p.log_alpha)}
            grads, p_metrics = core.value_and_grad(self.policy_loss, learnable,
                                                   p.actor_params.target, obs, action, adv)
            a_grads, d_grads = split_learnable(grads)
            c_grads, c_metrics = core.value_and_grad(
                self.critic_loss, p.critic_params, self.group(traj["obs"], u, 1),
                self.group(targets, u, 1))
            actor_grads.append(a_grads)
            dual_grads.append(d_grads)
            critic_grads.append(c_grads)
            metrics.append({**p_metrics, **c_metrics})
        actor_grads, dual_grads, critic_grads = anakin.data_mean(
            tuple(anakin.mean_gradients(g) for g in (actor_grads, dual_grads, critic_grads)),
            self.data_group)
        new_params, new_opts = [], []
        for p, opt in zip(params, opt_states):
            a_updates, a_opt = self.actor_optim.update(actor_grads, opt.actor_opt_state)
            actor_online = apply_updates(p.actor_params.online, a_updates)
            c_updates, c_opt = self.critic_optim.update(critic_grads, opt.critic_opt_state)
            d_updates, d_opt = self.dual_optim.update(dual_grads, opt.dual_opt_state)
            duals = apply_updates(dual_params(p.log_temperature, p.log_alpha), d_updates)
            log_temperature, log_alpha = project_duals(duals[LOG_TEMPERATURE], duals[LOG_ALPHA])
            # optax.periodic_update: the target becomes the NEW online actor
            # where the advanced count is a multiple of the period.
            step_count = p.step_count + 1
            actor_target = (actor_online if step_count % self.target_period == 0
                            else p.actor_params.target)
            new_params.append(VMPOParams(
                OnlineAndTarget(actor_online, actor_target),
                apply_updates(p.critic_params, c_updates), log_temperature, log_alpha,
                step_count))
            new_opts.append(VMPOOptStates(a_opt, c_opt, d_opt))
        return new_params, new_opts, join_metrics(metrics)

    def update(self, params: Any, opt_states: Any, traj: Dict) -> Tuple[Any, Any, Dict]:
        """`epochs` epochs over one trajectory; the metrics are the last's."""
        replica_params = anakin.split_replicas(params, self.update_batch)
        replica_opts = anakin.split_replicas(opt_states, self.update_batch)
        for _ in range(self.epochs):
            replica_params, replica_opts, metrics = self.epoch(replica_params, replica_opts, traj)
        return anakin.join_replicas(replica_params), anakin.join_replicas(replica_opts), metrics

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


def is_continuous(env: envs.Environment) -> bool:
    return isinstance(env.action_space(), spaces.Box)


def make_optimizers(config: Any) -> Tuple[ClipAdam, ClipAdam, ClipAdam]:
    """The actor's and the critic's clip + Adam (eps 1e-5; under
    `decay_learning_rates` decaying over `num_updates` steps, as the JAX
    ff_vmpo's `make_learning_rate(lr, config)` does) and the duals' plain Adam."""
    max_grad_norm = float(config.system.max_grad_norm)
    return (*(ClipAdam(make_learning_rate(float(config.system[key]), config), max_grad_norm,
                       eps=1e-5) for key in ("actor_lr", "critic_lr")),
            make_dual_optimizer(config))


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    """The actor and critic (initialised on the CPU from `seed`, then moved
    to `device`; the target actor starts as the online one), the duals, the
    three optimizers, the learner and its initial state."""
    refuse_ignored_knobs(config, str(config.system.system_name))
    config.system.action_dim = env.num_actions
    continuous = is_continuous(env)
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)
    actor, critic = ff_ppo.build_networks(env, config,
                                          anakin.make_generator(init_seed, torch.device("cpu")))
    actor.to(device)
    critic.to(device)
    apply_fns = (ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic))
    optims = make_optimizers(config)
    actor_p = {k: v.detach() for k, v in actor.named_parameters()}
    critic_p = {k: v.detach() for k, v in critic.named_parameters()}
    log_temperature, log_alpha = init_log_duals(config, continuous, int(env.num_actions), device)
    params = VMPOParams(OnlineAndTarget(actor_p, actor_p), critic_p, log_temperature, log_alpha, 0)
    opt_states = VMPOOptStates(optims[0].init(actor_p), optims[1].init(critic_p),
                               optims[2].init(dual_params(log_temperature, log_alpha)))
    update_batch = int(config.arch.get("update_batch_size", 1))
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    learner_state = OnPolicyLearnerState(
        anakin.broadcast_to_update_batch(params, update_batch),
        anakin.broadcast_to_update_batch(opt_states, update_batch),
        anakin.make_step_generators(step_seed, device, update_batch), env_state, timestep)
    return AnakinSetup(
        learn=VMPOLearner(env, apply_fns, optims, config, continuous),
        learner_state=learner_state,
        eval_act_fn=get_distribution_act_fn(config, apply_fns[0]),
        eval_params_fn=lambda s: anakin.split_replicas(
            s.params, update_batch)[0].actor_params.online,
    )


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin V-MPO; returns the final evaluation episode-return mean.
    Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_vmpo.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
