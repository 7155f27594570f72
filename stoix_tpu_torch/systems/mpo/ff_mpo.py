"""Anakin MPO (counterpart of stoix_tpu/systems/mpo/ff_mpo.py), the learner
of ff_mpo and ff_mpo_continuous (the continuous heads come from the network
config): Maximum a Posteriori Policy Optimisation (Abdolmaleki et al. 2018)
on the off-policy learner of systems/off_policy_core.py with the trajectory
buffer, no warm-up.

  - acting samples the ONLINE actor from the replica's generator and stores
    obs, action, its log-prob under the acting policy, reward and discount,
    added as [E_u, T] trajectories to the replica's buffer
    (`trajectory_buffer_sizing` with at least 2 x `rollout_length` slots);
  - each epoch samples [B, L] sequences a replica, then, all at the
    pre-update params (ff_mpo.py:99-238):
      * the Retrace target from the target actor and target critic, without
        gradient: log rho = log pi_target(a) - log mu(a); v(s) the target
        actor's expected target Q (all actions, or the mean over
        `num_samples` sampled actions); `retrace_continuous` over every
        replica's sequences in ONE call (one launch of B1's generic entry
        under `system.multistep_impl: pallas`, over [L - 2, U.B] from the
        batch-major view); the critic's loss 0.5 mean((G - Q(s, a))^2) over
        the first L - 1 steps;
      * the policy's loss on the [B.L] observations: the E-step over all
        actions (discrete: softmax(Q / eta + prior logits)) or over the N
        sampled actions (continuous: softmax over the samples of Q / eta),
        eta's dual loss, the weighted max-likelihood (continuous: decomposed
        into a fixed-stddev and a fixed-mean Gaussian), the KL(target ||
        online) penalty and alpha's dual loss;
      * the critic's, the actor's and the duals' gradients averaged over
        the replicas, then the data ranks, in one all-reduce; clip + Adam
        steps and Polyak updates of both online/target pairs, plain Adam
        (eps 1e-8) of the duals, floored at -18.

Every sample Q value (N . B . L rows of (obs, action) at the continuous
default, twice an epoch) goes through the target critic under `no_grad` in
one batched pass. The noise comes from the replica's generator through
`draw_noise`, after the buffer's sample. The discrete critic is a
FeedForwardActor with a DiscreteQNetworkHead (epsilon 0) on the actor's
input layer, read through its `preferences`, as in the JAX package. The JAX
ff_mpo does not read `system.update_guard`; the port refuses it (ROADMAP C19).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import OffPolicyLearnerState, OnlineAndTarget
from stoix_tpu_torch.buffers import make_trajectory_buffer
from stoix_tpu_torch.evaluator import get_distribution_act_fn
from stoix_tpu_torch.ops import distributions as dists
from stoix_tpu_torch.ops.multistep import retrace_continuous
from stoix_tpu_torch.systems import anakin, off_policy_core as core
from stoix_tpu_torch.systems.ddpg import ff_ddpg
from stoix_tpu_torch.systems.ddpg.ff_ddpg import join_metrics, refuse_ignored_knobs
from stoix_tpu_torch.systems.mpo.ff_vmpo import (
    LOG_ALPHA, LOG_TEMPERATURE, _softplus, categorical_alpha_losses, decomposed_dists,
    decoupled_alpha_losses, dual_params, gaussian_kls_per_dim, gaussian_params, init_log_duals,
    is_continuous, make_dual_optimizer, project_duals, split_learnable,
)
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import _cat
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import (
    ClipAdam, apply_updates, incremental_update, make_learning_rate,
)
from stoix_tpu_torch.utils.tree import tree_map, tree_merge_leading_dims


class MPOParams(NamedTuple):
    actor_params: OnlineAndTarget
    q_params: OnlineAndTarget
    log_temperature: torch.Tensor
    log_alpha: torch.Tensor  # a scalar (discrete) or [2, A] mean and stddev (continuous)


class MPOOptStates(NamedTuple):
    actor_opt_state: Any
    q_opt_state: Any
    dual_opt_state: Any


def store_step(last_timestep: Any, action: torch.Tensor, timestep: Any, acted: Dict) -> dict:
    """What the buffer keeps of one step (and its episode info, not stored)."""
    return {
        "obs": last_timestep.observation,
        "action": action,
        "log_prob": acted["log_prob"],
        "reward": timestep.reward,
        "discount": timestep.discount,
        "info": timestep.extras["episode_metrics"],
    }


def dummy_item(env: envs.Environment, continuous: bool, device: Any) -> dict:
    return {
        "obs": tree_map(lambda x: x.to(device), env.observation_value()),
        "action": torch.as_tensor(env.action_value(),
                                  dtype=torch.float32 if continuous else torch.int32).to(device),
        **{k: torch.zeros((), dtype=torch.float32, device=device)
           for k in ("log_prob", "reward", "discount")},
    }


def build_networks(env: envs.Environment, config: Any, generator: torch.Generator,
                   continuous: bool) -> Tuple[torch.nn.Module, torch.nn.Module]:
    """(actor, q_network): the actor from `network.actor_network`; a Q(s, a)
    critic from `network.critic_network` (continuous), or a FeedForwardActor
    with a DiscreteQNetworkHead (epsilon 0) on the critic's torso and the
    ACTOR's input layer (discrete, ff_mpo.py:287-302)."""
    from stoix_tpu_torch.networks.base import FeedForwardActor
    from stoix_tpu_torch.networks.heads import DiscreteQNetworkHead

    actor = ff_ppo.build_actor(env, config, generator)
    if continuous:
        return actor, ff_ddpg.build_critic(env, config, generator)
    q_input = config_lib.instantiate(config.network.actor_network.input_layer)
    in_dim = int(q_input(env.observation_value()).shape[-1])
    q_torso = config_lib.instantiate(config.network.critic_network.pre_torso, input_dim=in_dim,
                                     generator=generator)
    q_head = DiscreteQNetworkHead(env.num_actions, q_torso.output_dim, epsilon=0.0,
                                  generator=generator)
    return actor, FeedForwardActor(q_head, q_torso, q_input)


def _repeat(tree: Any, times: int) -> Any:
    """Every leaf with a new leading axis of `times` copies (a view)."""
    return tree_map(lambda x: x.expand((times,) + tuple(x.shape)), tree)


class MPOUpdate:
    """`update_from_batch` of MPO over lists of one [B, L] sequence batch a
    replica: `update(params, opt_states, batches, generators)` draws each
    replica's normals (`draw_noise`) and hands them to `step`, which a test
    can call with its own."""

    def __init__(self, actor_apply: Callable, q_apply: Callable,
                 optims: Tuple[ClipAdam, ClipAdam, ClipAdam], config: Any, continuous: bool):
        self.actor_apply, self.q_apply = actor_apply, q_apply
        self.actor_optim, self.q_optim, self.dual_optim = optims
        self.continuous = continuous
        system = config.system
        self.gamma = float(system.gamma)
        self.tau = float(system.tau)
        self.retrace_lambda = float(system.get("retrace_lambda", 0.95))
        self.num_samples = int(system.get("num_samples", 16))
        self.eps_eta = float(system.get("epsilon_eta", 0.1))
        self.eps_alpha = float(system.get("epsilon_alpha", 0.01))
        self.eps_alpha_mean = float(system.get("epsilon_alpha_mean", 0.0075))
        self.eps_alpha_stddev = float(system.get("epsilon_alpha_stddev", 1e-5))
        self.multistep_impl = str(system.get("multistep_impl", "scan"))
        self.data_group = anakin.data_group()

    # ------------------------------------------------------------ noise

    def draw_noise(self, batch: Dict, generator: Optional[torch.Generator]
                   ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The continuous losses' standard normals: the critic's [N, B, L, A]
        and the policy's [N, B.L, A] (the JAX package's `critic_key` and
        `policy_key` draws); None for a discrete policy."""
        if not self.continuous:
            return None
        action = batch["action"]
        shape = (self.num_samples,) + tuple(action.shape)
        critic = torch.randn(shape, generator=generator, device=action.device)
        policy = torch.randn(shape, generator=generator, device=action.device)
        return critic, policy.reshape((self.num_samples, -1) + tuple(action.shape[2:]))

    def __call__(self, params: List[MPOParams], opt_states: List[MPOOptStates],
                 batches: List[Dict], generators: Optional[Sequence[torch.Generator]] = None):
        generators = [None] * len(batches) if generators is None else generators
        return self.step(params, opt_states, batches,
                         [self.draw_noise(b, g) for b, g in zip(batches, generators)])

    # ------------------------------------------------------------ the losses

    def q_values(self, q_params: Dict[str, torch.Tensor], obs: Any, action: torch.Tensor
                 ) -> torch.Tensor:
        """Q(s, a): the critic's output, or the taken action's preference."""
        if self.continuous:
            return self.q_apply(q_params, obs, action)
        preferences = self.q_apply(q_params, obs, 0.0).preferences
        return torch.gather(preferences, -1, action.long().unsqueeze(-1)).squeeze(-1)

    @torch.no_grad()
    def retrace_inputs(self, params: MPOParams, batch: Dict, noise: Any) -> Tuple:
        """(q_t, v_t, log_rhos) [B, L] of one replica's sequences, from the
        target actor and the target critic."""
        obs, action = batch["obs"], batch["action"]
        target_dist = self.actor_apply(params.actor_params.target, obs)
        log_rhos = target_dist.log_prob(action) - batch["log_prob"]
        q_target = params.q_params.target
        if self.continuous:
            sampled = target_dist.sample(noise=noise[0])  # [N, B, L, A]
            v_t = torch.mean(self.q_apply(q_target, _repeat(obs, self.num_samples), sampled), 0)
        else:
            q_all = self.q_apply(q_target, obs, 0.0).preferences
            probs = dists.Categorical(target_dist.logits).probs
            v_t = torch.sum(probs * q_all, dim=-1)
        return self.q_values(q_target, obs, action), v_t, log_rhos

    def retrace_targets(self, params: List[MPOParams], batches: List[Dict],
                        noises: Sequence[Any]) -> List[torch.Tensor]:
        """Each replica's Retrace target [B, L - 1], every replica's from ONE
        `retrace_continuous` call over [U.B, L] (its error against a zero
        q_tm1 is the target itself), without gradient."""
        with torch.no_grad():
            inputs = [self.retrace_inputs(p, b, n) for p, b, n in zip(params, batches, noises)]
            q_t, v_t, log_rhos = (_cat([x[i] for x in inputs], 0) for i in range(3))
            reward, discount = (_cat([b[k] for b in batches], 0) for k in ("reward", "discount"))
            targets = retrace_continuous(
                torch.zeros_like(reward[:, :-1]), q_t[:, 1:-1], v_t[:, 1:], reward[:, :-1],
                self.gamma * discount[:, :-1], log_rhos[:, 1:-1], self.retrace_lambda,
                impl=self.multistep_impl)
            return list(targets.split([b["reward"].shape[0] for b in batches]))

    def q_loss(self, q_online: Dict[str, torch.Tensor], batch: Dict, target: torch.Tensor):
        q_tm1 = self.q_values(q_online, batch["obs"], batch["action"])
        loss = 0.5 * torch.mean((target - q_tm1[:, :-1]) ** 2)
        return loss, {"q_loss": loss, "mean_q": torch.mean(q_tm1)}

    def policy_loss(self, learnable: Dict[str, torch.Tensor], params: MPOParams, batch: Dict,
                    noise: Any):
        """The E-step, M-step and dual losses on the [B.L] observations
        (ff_mpo.py:134-193)."""
        actor_online, duals = split_learnable(learnable)
        eta = _softplus(duals[LOG_TEMPERATURE])
        obs = tree_merge_leading_dims(batch["obs"], 2)
        online_dist = self.actor_apply(actor_online, obs)
        with torch.no_grad():
            target_dist = self.actor_apply(params.actor_params.target, obs)
        q_target = params.q_params.target
        if self.continuous:
            with torch.no_grad():
                actions = target_dist.sample(noise=noise[1])  # [N, B.L, A]
                q_vals = self.q_apply(q_target, _repeat(obs, self.num_samples), actions)
            weights = torch.softmax(q_vals / eta, dim=0)
            temperature_loss = eta * self.eps_eta + eta * torch.mean(
                torch.logsumexp(q_vals / eta, dim=0) - math.log(float(self.num_samples)))
            fixed_std, fixed_mean = decomposed_dists(target_dist, online_dist)
            w = weights.detach()
            policy_loss = (-torch.mean(torch.sum(w * fixed_std.log_prob(actions), dim=0))
                           - torch.mean(torch.sum(w * fixed_mean.log_prob(actions), dim=0)))
            kl_mean, kl_std = gaussian_kls_per_dim(*gaussian_params(target_dist),
                                                   *gaussian_params(online_dist))
            alpha_loss, kl_loss, kl_metric = decoupled_alpha_losses(
                duals[LOG_ALPHA], kl_mean, kl_std, self.eps_alpha_mean, self.eps_alpha_stddev)
        else:
            with torch.no_grad():
                q_all = self.q_apply(q_target, obs, 0.0).preferences  # [B.L, A]
                prior_logits = dists.Categorical(target_dist.logits).logits
            # The nonparametric posterior, weighted by the prior, in log space.
            improved = torch.softmax(q_all / eta + prior_logits, dim=-1)
            temperature_loss = eta * self.eps_eta + eta * torch.mean(
                torch.logsumexp(q_all / eta + prior_logits, dim=-1))
            policy_loss = -torch.mean(torch.sum(improved.detach() * online_dist.logits, dim=-1))
            kl = torch.mean(dists.Categorical(target_dist.logits).kl_divergence(online_dist))
            alpha_loss, kl_loss, kl_metric = categorical_alpha_losses(duals[LOG_ALPHA], kl,
                                                                      self.eps_alpha)
        total = policy_loss + temperature_loss + alpha_loss + kl_loss
        return total, {"policy_loss": policy_loss, "temperature": eta, "kl": kl_metric}

    # ------------------------------------------------------------ the update

    def step(self, params: List[MPOParams], opt_states: List[MPOOptStates],
             batches: List[Dict], noises: Sequence[Any]):
        targets = self.retrace_targets(params, batches, noises)
        q_grads, actor_grads, dual_grads, metrics = [], [], [], []
        for p, batch, target, noise in zip(params, batches, targets, noises):
            g_q, q_metrics = core.value_and_grad(self.q_loss, p.q_params.online, batch, target)
            learnable = {**p.actor_params.online, **dual_params(p.log_temperature, p.log_alpha)}
            grads, p_metrics = core.value_and_grad(self.policy_loss, learnable, p, batch, noise)
            g_actor, g_duals = split_learnable(grads)
            q_grads.append(g_q)
            actor_grads.append(g_actor)
            dual_grads.append(g_duals)
            metrics.append({**q_metrics, **p_metrics})
        q_grads, actor_grads, dual_grads = anakin.data_mean(
            tuple(anakin.mean_gradients(g) for g in (q_grads, actor_grads, dual_grads)),
            self.data_group)
        new_params, new_opts = [], []
        for p, opt in zip(params, opt_states):
            q_updates, q_opt = self.q_optim.update(q_grads, opt.q_opt_state)
            q_online = apply_updates(p.q_params.online, q_updates)
            a_updates, a_opt = self.actor_optim.update(actor_grads, opt.actor_opt_state)
            actor_online = apply_updates(p.actor_params.online, a_updates)
            d_updates, d_opt = self.dual_optim.update(dual_grads, opt.dual_opt_state)
            duals = apply_updates(dual_params(p.log_temperature, p.log_alpha), d_updates)
            new_params.append(MPOParams(
                OnlineAndTarget(actor_online, incremental_update(actor_online,
                                                                 p.actor_params.target, self.tau)),
                OnlineAndTarget(q_online, incremental_update(q_online, p.q_params.target,
                                                             self.tau)),
                *project_duals(duals[LOG_TEMPERATURE], duals[LOG_ALPHA])))
            new_opts.append(MPOOptStates(a_opt, q_opt, d_opt))
        return new_params, new_opts, join_metrics(metrics)


def make_optimizers(config: Any) -> Tuple[ClipAdam, ClipAdam, ClipAdam]:
    """The actor's and the critic's clip + Adam (eps 1e-5; under
    `decay_learning_rates` over every epoch of the run, as the JAX ff_mpo's
    `make_learning_rate(lr, config, epochs)`) and the duals' plain Adam."""
    epochs, max_grad_norm = int(config.system.epochs), float(config.system.max_grad_norm)
    return (*(ClipAdam(make_learning_rate(float(config.system[key]), config, epochs),
                       max_grad_norm, eps=1e-5) for key in ("actor_lr", "q_lr")),
            make_dual_optimizer(config))


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    """The networks (initialised on the CPU from `seed`, then moved to
    `device`; each target starts as its online copy), the duals, the three
    optimizers, one trajectory buffer a replica, the learner and its
    initial state."""
    refuse_ignored_knobs(config, str(config.system.system_name))
    config.system.action_dim = env.num_actions
    continuous = is_continuous(env)
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)
    actor, q_network = build_networks(env, config,
                                      anakin.make_generator(init_seed, torch.device("cpu")),
                                      continuous)
    actor.to(device)
    q_network.to(device)
    actor_apply, q_apply = ff_ddpg.make_apply(actor), ff_ddpg.make_apply(q_network)
    optims = make_optimizers(config)
    actor_p, q_p = ff_ddpg.detached_params(actor), ff_ddpg.detached_params(q_network)
    log_temperature, log_alpha = init_log_duals(config, continuous, int(env.num_actions), device)
    params = MPOParams(OnlineAndTarget(actor_p, actor_p), OnlineAndTarget(q_p, q_p),
                       log_temperature, log_alpha)
    opt_states = MPOOptStates(optims[0].init(actor_p), optims[1].init(q_p),
                              optims[2].init(dual_params(log_temperature, log_alpha)))

    update_batch = int(config.arch.get("update_batch_size", 1))
    local_envs, sample_batch, max_length = core.trajectory_buffer_sizing(
        config, 2 * int(config.system.rollout_length))
    buffer = make_trajectory_buffer(
        add_batch_size=local_envs,
        sample_batch_size=sample_batch,
        sample_sequence_length=int(config.system.get("sample_sequence_length", 8)),
        period=int(config.system.get("sample_period", 1)),
        max_length_time_axis=max_length,
    )

    def act_in_env(params: MPOParams, observation: Any, generator: torch.Generator,
                   buffer_state: Any = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        dist = actor_apply(params.actor_params.online, observation)
        action = dist.sample(generator)
        return action, {"log_prob": dist.log_prob(action)}

    learner = core.OffPolicyLearner(env, buffer, config,
                                    MPOUpdate(actor_apply, q_apply, optims, config, continuous),
                                    act_in_env, store=store_step, update_takes_generators=True)
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    learner_state = OffPolicyLearnerState(
        params=anakin.broadcast_to_update_batch(params, update_batch),
        opt_states=anakin.broadcast_to_update_batch(opt_states, update_batch),
        buffer_state=anakin.join_per_replica(
            [buffer.init(dummy_item(env, continuous, device)) for _ in range(update_batch)]),
        generator=anakin.make_step_generators(step_seed, device, update_batch),
        env_state=env_state,
        timestep=timestep,
    )
    return AnakinSetup(
        learn=learner,
        learner_state=learner_state,
        eval_act_fn=get_distribution_act_fn(config, actor_apply),
        eval_params_fn=lambda s: anakin.split_replicas(
            s.params, update_batch)[0].actor_params.online,
    )


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin MPO; returns the final evaluation episode-return mean.
    Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_mpo.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
