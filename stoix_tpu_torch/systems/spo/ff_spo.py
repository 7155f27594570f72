"""Anakin SPO (counterpart of stoix_tpu/systems/spo/ff_spo.py), the learner
of ff_spo and ff_spo_continuous (the continuous head comes from the network
config): Sequential Monte Carlo Policy Optimisation on the off-policy
learner with the trajectory buffer, no warm-up.

Acting (ff_spo.py:98-208): each step, every replica runs the SMC search on
its envs at once, N = `num_particles` particles an env as [E.N] rows (env
e's particles rows e.N to e.N + N - 1):

  1. the root: the core env states (below every wrapper's `inner`, with the
     replica's step generator in place of the live env's, as ff_az's
     simulator takes them) and observations tiled N times; N actions drawn
     from the online actor;
  2. `search_horizon` steps of the pristine simulator (`make_simulator`: no
     step limit, no auto-reset; a particle whose episode ended keeps
     stepping, `alive` masks what it adds): delta = r + gamma . discount .
     V(s') - V(s) from the online critic; the log-weight adds
     alive . delta / eta (eta the softplus of the learned temperature), the
     raw advantage sum alive . delta; then, per env, the effective sample
     size 1 / sum(w^2) of the weights' softmax, and where it is below
     `ess_threshold` . N, multinomial resampling: every particle leaf (the
     core state's tensors, the observation, the root action, the advantage
     sum, `alive`) gathered from the drawn indices and the log-weights
     zeroed, by one index a row (the identity where an env does not
     resample), so no host reads the ESS; then the next actions, except
     after the last step;
  3. the weights' softmax; one particle's root action chosen by
     log(w + 1e-9) (XLA's exp and log, `mcts.softmax`, `xla_log_f32`, as
     the decisions depend on them), the live env stepped with it.

Every draw (the root and next actions' Gumbel or standard normal draws, the
resampling's [N, N] Gumbel draws an env and step, the choice's [N]) comes
from the replica's generator in `SMCSearch.draw_noise` and is handed to the
search, so a test can feed the JAX package's. The buffer stores obs,
next_obs, action, reward, done, truncated and the particles' root actions,
weights and advantage sums.

Each of `epochs` epochs samples [B, L] sequences a replica and, all at the
pre-update params (ff_spo.py:210-337): the critic's target is truncated GAE
from the TARGET critic over the sequences (v_tm1 on obs, v_t on next_obs,
the stored truncations; no gradient), every replica's batch in ONE call
(batch-major: one launch of B1's GAE entry an epoch under
`system.multistep_impl: pallas`); the policy's loss on the [B.L]
observations: the cross-entropy to the stored SMC weights over the
particles' root actions, the temperature's dual on the raw advantage sums,
the KL(target || online) penalty with its alpha dual (per-dimension mean and
stddev alphas for a Gaussian policy) and `ent_coef` . entropy; the critic's
`vf_coef` . 0.5 mean((V - G)^2); the actor's, the duals' and the critic's
gradients averaged over the replicas, then the data ranks, in one
all-reduce; clip + Adam steps of the actor and critic, Polyak updates of
both targets at `tau`, plain Adam of the duals, floored at -18.

The JAX ff_spo does not read `system.update_guard`; the port refuses it
(ROADMAP C22).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import OffPolicyLearnerState, OnlineAndTarget
from stoix_tpu_torch.evaluator import get_distribution_act_fn
from stoix_tpu_torch.ops import distributions as dists
from stoix_tpu_torch.ops import truncated_generalized_advantage_estimation
from stoix_tpu_torch.ops.multistep import xla_log_f32
from stoix_tpu_torch.search import mcts
from stoix_tpu_torch.systems import anakin, off_policy_core as core
from stoix_tpu_torch.systems.ddpg.ff_ddpg import join_metrics, refuse_ignored_knobs
from stoix_tpu_torch.systems.mpo.ff_vmpo import (
    LOG_ALPHA, LOG_TEMPERATURE, _softplus, categorical_alpha_losses, decoupled_alpha_losses,
    dual_params, gaussian_kls_per_dim, gaussian_params, init_log_duals, is_continuous,
    make_dual_optimizer, project_duals, split_learnable,
)
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import _cat
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.systems.search.ff_az import (
    SearchReplayLearner, _truncated, make_simulator, replay_buffer,
)
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import (
    ClipAdam, apply_updates, incremental_update, make_learning_rate,
)
from stoix_tpu_torch.utils.tree import tree_map, tree_merge_leading_dims


class SPOParams(NamedTuple):
    actor_params: OnlineAndTarget
    critic_params: OnlineAndTarget
    log_temperature: torch.Tensor  # eta's dual (the SMC weights), a float32 scalar
    log_alpha: torch.Tensor  # the KL dual: a scalar (categorical) or [2, A] (Gaussian)


class SPOOptStates(NamedTuple):
    actor_opt_state: Any
    critic_opt_state: Any
    dual_opt_state: Any  # plain Adam over {log_temperature, log_alpha}


class SPONoise(NamedTuple):
    """One searched step's draws for E envs (N particles, horizon H; A the
    actions of a Categorical policy, or the action dim d of a Gaussian)."""

    root: torch.Tensor  # [E, N, A] Gumbel or [E, N, d] standard normal draws
    next: torch.Tensor  # [H - 1, E, N, A or d]: the next actions after each step but the last
    resample: torch.Tensor  # [H, E, N, N] Gumbel draws: particle i's source index is argmax_j
    choice: torch.Tensor  # [E, N] Gumbel draws of the executed particle


class SMCOutput(NamedTuple):
    particle_actions: torch.Tensor  # [E, N, ...] the particles' root actions
    weights: torch.Tensor  # [E, N] softmax of the final log-weights
    raw_advantages: torch.Tensor  # [E, N] unscaled advantage sums
    resampled: torch.Tensor  # [H, E] bool: where each env resampled after each step


class SMCSearch:
    """The SMC search over a replica's envs (`_smc_search`, ff_spo.py:98-167)."""

    def __init__(self, sim_env: envs.Environment, apply_fns: Tuple[Callable, Callable],
                 config: Any, continuous: bool, action_dim: int):
        self.sim_env = sim_env
        self.actor_apply, self.critic_apply = apply_fns
        self.continuous = continuous
        self.action_dim = int(action_dim)
        system = config.system
        self.gamma = float(system.gamma)
        self.num_particles = int(system.get("num_particles", 16))
        self.horizon = int(system.get("search_horizon", 4))
        # Resample where ess < ess_threshold . N (a host float, as in the JAX package).
        self.ess_floor = float(system.get("ess_threshold", 0.5)) * self.num_particles

    def draw_noise(self, generator: torch.Generator, batch: int) -> SPONoise:
        device = generator.device
        n = self.num_particles
        shape = (batch, n, self.action_dim)

        def actions(lead: Tuple[int, ...]) -> torch.Tensor:
            if self.continuous:
                return torch.randn(lead + shape, generator=generator, device=device)
            return mcts.gumbel(generator, lead + shape, device)

        return SPONoise(actions(()), actions((self.horizon - 1,)),
                        mcts.gumbel(generator, (self.horizon, batch, n, n), device),
                        mcts.gumbel(generator, (batch, n), device))

    def sample(self, dist: Any, noise: torch.Tensor) -> torch.Tensor:
        """Actions [E.N, ...] of the policy on the particles from noise [E, N, ...]."""
        noise = noise.reshape((-1,) + tuple(noise.shape[2:]))
        if self.continuous:
            return dist.sample(noise=noise)
        return (dist.logits + noise).argmax(-1)

    def __call__(self, params: SPOParams, noise: SPONoise, state: Any,
                 observation: Any) -> SMCOutput:
        """The search from the envs' core `state` and `observation` ([E]
        leading); nothing is read back to the host."""
        n = self.num_particles
        batch = observation.agent_view.shape[0]
        device = observation.agent_view.device
        actor, critic = params.actor_params.online, params.critic_params.online
        eta = _softplus(params.log_temperature)
        state, obs = tree_map(lambda x: x.repeat_interleave(n, 0), (state, observation))
        first_action = self.sample(self.actor_apply(actor, obs), noise.root)
        action = first_action
        log_weight = torch.zeros((batch, n), device=device)
        raw_adv = torch.zeros((batch, n), device=device)
        alive = torch.ones((batch, n), device=device)
        rows = torch.arange(batch * n, device=device).view(batch, n)
        env_rows = rows[:, :1]  # each env's first row
        resampled = []
        for step in range(self.horizon):
            state, ts = self.sim_env.step(state, action)
            v_next = self.critic_apply(critic, ts.observation).view(batch, n)
            v_cur = self.critic_apply(critic, obs).view(batch, n)
            discount = ts.discount.view(batch, n)
            # r + (gamma . discount) . v_next is one fused multiply-add under jax.jit.
            delta = mcts.fused_multiply_add(self.gamma * discount, v_next,
                                            ts.reward.view(batch, n)) - v_cur
            log_weight = log_weight + alive * delta / eta
            raw_adv = raw_adv + alive * delta
            alive = alive * discount
            obs = ts.observation
            weights = mcts.softmax(log_weight)
            resample = 1.0 / torch.sum(weights * weights, -1) < self.ess_floor  # [E]
            drawn = (noise.resample[step] + log_weight[:, None, :]).argmax(-1)  # [E, N]
            source = torch.where(resample[:, None], env_rows + drawn, rows).reshape(-1)
            state, obs, first_action = tree_map(lambda x: x.index_select(0, source),
                                                (state, obs, first_action))
            raw_adv, alive = (x.reshape(-1).index_select(0, source).view(batch, n)
                              for x in (raw_adv, alive))
            # A resampled env's log-weights restart at 0; the others gather
            # their own rows, which leaves them as they are.
            log_weight = torch.where(resample[:, None], 0.0, log_weight)
            resampled.append(resample)
            if step + 1 < self.horizon:
                action = self.sample(self.actor_apply(actor, obs), noise.next[step])
        particle_actions = first_action.view((batch, n) + tuple(first_action.shape[1:]))
        return SMCOutput(particle_actions, mcts.softmax(log_weight), raw_adv,
                         torch.stack(resampled))


def choose(particle_actions: torch.Tensor, weights: torch.Tensor,
           gumbel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the executed actions [E, ...], the chosen particle [E]): one particle
    an env drawn by log(w + 1e-9) with the Gumbel draws [E, N]."""
    choice = (gumbel + xla_log_f32(weights + 1e-9, mcts.fused_multiply_add)).argmax(-1)
    rows = torch.arange(choice.shape[0], device=choice.device)
    return particle_actions[rows, choice], choice


class SPOActing:
    """ff_spo's acting for `SearchReplayLearner` (ff_spo.py:169-208)."""

    def __init__(self, search: SMCSearch):
        self.search = search

    def draw_noise(self, generator: torch.Generator, batch: int) -> SPONoise:
        return self.search.draw_noise(generator, batch)

    def act(self, params: SPOParams, noise: SPONoise, sim_state: Any, observation: Any):
        out = self.search(params, noise, sim_state, observation)
        action, _ = choose(out.particle_actions, out.weights, noise.choice)
        return action, {"particle_actions": out.particle_actions,
                        "particle_weights": out.weights,
                        "particle_advs": out.raw_advantages}

    def record(self, params, last_timestep, action, timestep, extras) -> Dict[str, Any]:
        return {
            "done": (timestep.discount == 0.0).to(torch.float32),
            "truncated": _truncated(timestep),
            "action": action,
            **extras,
            "reward": timestep.reward,
            "obs": last_timestep.observation,
            "next_obs": timestep.extras["next_obs"],
            "info": timestep.extras["episode_metrics"],
        }


class SPOUpdate:
    """`update_from_batch` of SPO over lists of one [B, L] sequence batch a
    replica (ff_spo.py:210-337)."""

    def __init__(self, apply_fns: Tuple[Callable, Callable],
                 optims: Tuple[ClipAdam, ClipAdam, ClipAdam], config: Any, continuous: bool):
        self.actor_apply, self.critic_apply = apply_fns
        self.actor_optim, self.critic_optim, self.dual_optim = optims
        self.continuous = continuous
        system = config.system
        self.gamma = float(system.gamma)
        self.gae_lambda = float(system.get("gae_lambda", 0.95))
        self.tau = float(system.get("tau", 0.005))
        self.vf_coef = float(system.get("vf_coef", 0.5))
        self.ent_coef = float(system.get("ent_coef", 0.0))
        self.eps_eta = float(system.get("epsilon_eta", 0.1))
        self.eps_alpha = float(system.get("epsilon_policy", 1e-3))
        self.eps_alpha_mean = float(system.get("epsilon_alpha_mean", 0.0075))
        self.eps_alpha_stddev = float(system.get("epsilon_alpha_stddev", 1e-5))
        self.multistep_impl = str(system.get("multistep_impl", "scan"))
        self.data_group = anakin.data_group()

    def value_targets(self, params: Sequence[SPOParams], batches: Sequence[Dict]
                      ) -> List[torch.Tensor]:
        """Each replica's GAE targets [B, L] from its TARGET critic, every
        replica's sequences in ONE batch-major call, without gradient."""
        with torch.no_grad():
            v_tm1, v_t = (_cat([self.critic_apply(p.critic_params.target, b[key])
                                for p, b in zip(params, batches)], 0)
                          for key in ("obs", "next_obs"))
            reward, done, truncated = (_cat([b[k] for b in batches], 0)
                                       for k in ("reward", "done", "truncated"))
            _, targets = truncated_generalized_advantage_estimation(
                reward, self.gamma * (1.0 - done), self.gae_lambda, v_tm1=v_tm1, v_t=v_t,
                truncation_t=truncated, batch_major=True, impl=self.multistep_impl)
        return list(targets.split([b["reward"].shape[0] for b in batches]))

    def particle_log_probs(self, dist: Any, particle_actions: torch.Tensor) -> torch.Tensor:
        """log pi of each particle's root action under `dist` ([BL] batch): [BL, N]."""
        if self.continuous:
            return dist.log_prob(particle_actions.transpose(0, 1)).transpose(0, 1)
        return torch.gather(dist.logits, -1, particle_actions.long())

    def policy_loss(self, learnable: Dict[str, torch.Tensor], target_params: Dict, obs: Any,
                    particle_actions: torch.Tensor, particle_weights: torch.Tensor,
                    particle_advs: torch.Tensor):
        """The SMC cross-entropy, the temperature's and alpha's duals and the
        KL penalty on the [B.L] observations (ff_spo.py:210-271)."""
        actor_params, duals = split_learnable(learnable)
        eta = _softplus(duals[LOG_TEMPERATURE])
        online = self.actor_apply(actor_params, obs)
        with torch.no_grad():
            target = self.actor_apply(target_params, obs)
        log_probs = self.particle_log_probs(online, particle_actions)
        policy_loss = -torch.mean(torch.sum(particle_weights * log_probs, -1))
        # The dual on the RAW advantage sums (the normalised weights would
        # make its log-sum-exp identically log(1)).
        temperature_loss = eta * self.eps_eta + eta * torch.mean(
            torch.logsumexp(particle_advs / eta, -1) - math.log(particle_advs.shape[-1]))
        if self.continuous:
            kl_mean, kl_std = gaussian_kls_per_dim(*gaussian_params(target),
                                                   *gaussian_params(online))
            alpha_loss, kl_loss, kl_metric = decoupled_alpha_losses(
                duals[LOG_ALPHA], kl_mean, kl_std, self.eps_alpha_mean, self.eps_alpha_stddev)
        else:
            kl = torch.mean(dists.Categorical(target.logits).kl_divergence(online))
            alpha_loss, kl_loss, kl_metric = categorical_alpha_losses(duals[LOG_ALPHA], kl,
                                                                      self.eps_alpha)
        entropy = online.entropy().mean()
        total = policy_loss + temperature_loss + alpha_loss + kl_loss - self.ent_coef * entropy
        return total, {"policy_loss": policy_loss, "temperature": eta, "kl": kl_metric,
                       "entropy": entropy}

    def critic_loss(self, critic_params: Dict[str, torch.Tensor], obs: Any,
                    targets: torch.Tensor):
        loss = self.vf_coef * 0.5 * torch.mean((self.critic_apply(critic_params, obs)
                                                - targets) ** 2)
        return loss, {"value_loss": loss}

    def __call__(self, params: List[SPOParams], opt_states: List[SPOOptStates],
                 batches: List[Dict]):
        targets = self.value_targets(params, batches)
        actor_grads, dual_grads, critic_grads, metrics = [], [], [], []
        for p, batch, target in zip(params, batches, targets):
            learnable = {**p.actor_params.online, **dual_params(p.log_temperature, p.log_alpha)}
            grads, p_metrics = core.value_and_grad(
                self.policy_loss, learnable, p.actor_params.target,
                tree_merge_leading_dims(batch["obs"], 2),
                *(tree_merge_leading_dims(batch[k], 2)
                  for k in ("particle_actions", "particle_weights", "particle_advs")))
            a_grads, d_grads = split_learnable(grads)
            c_grads, c_metrics = core.value_and_grad(self.critic_loss, p.critic_params.online,
                                                     batch["obs"], target)
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
            critic_online = apply_updates(p.critic_params.online, c_updates)
            d_updates, d_opt = self.dual_optim.update(dual_grads, opt.dual_opt_state)
            duals = apply_updates(dual_params(p.log_temperature, p.log_alpha), d_updates)
            new_params.append(SPOParams(
                OnlineAndTarget(actor_online, incremental_update(actor_online,
                                                                 p.actor_params.target, self.tau)),
                OnlineAndTarget(critic_online, incremental_update(
                    critic_online, p.critic_params.target, self.tau)),
                *project_duals(duals[LOG_TEMPERATURE], duals[LOG_ALPHA])))
            new_opts.append(SPOOptStates(a_opt, c_opt, d_opt))
        return new_params, new_opts, join_metrics(metrics)


def make_optimizers(config: Any) -> Tuple[ClipAdam, ClipAdam, ClipAdam]:
    """The actor's and the critic's clip + Adam (eps 1e-5; under
    `decay_learning_rates` over every epoch of the run) and the duals' plain Adam."""
    epochs, max_grad_norm = int(config.system.epochs), float(config.system.max_grad_norm)
    return (*(ClipAdam(make_learning_rate(float(config.system[key]), config, epochs),
                       max_grad_norm, eps=1e-5) for key in ("actor_lr", "critic_lr")),
            make_dual_optimizer(config))


def action_dim(env: envs.Environment, continuous: bool) -> int:
    """A Categorical policy's number of actions, or a Gaussian's action dim."""
    return int(np.asarray(env.action_value()).shape[-1]) if continuous else int(env.num_actions)


def dummy_item(env: envs.Environment, continuous: bool, num_particles: int, device: Any) -> Dict:
    obs = tree_map(lambda x: x.to(device), env.observation_value())
    action = torch.as_tensor(env.action_value(),
                             dtype=torch.float32 if continuous else torch.int32).to(device)
    scalar = lambda: torch.zeros((), dtype=torch.float32, device=device)  # noqa: E731
    return {"done": scalar(), "truncated": scalar(), "action": action,
            "particle_actions": action.expand((num_particles,) + tuple(action.shape)).clone(),
            "particle_weights": torch.zeros((num_particles,), device=device),
            "particle_advs": torch.zeros((num_particles,), device=device),
            "reward": scalar(), "obs": obs, "next_obs": tree_map(lambda x: x.clone(), obs)}


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    """The actor and critic (initialised on the CPU from `seed`, then moved
    to `device`; each target starts as its online copy), the duals, the
    three optimizers, the simulator, one trajectory buffer a replica, the
    learner and its initial state."""
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
    params = SPOParams(OnlineAndTarget(actor_p, actor_p), OnlineAndTarget(critic_p, critic_p),
                       log_temperature, log_alpha)
    opt_states = SPOOptStates(optims[0].init(actor_p), optims[1].init(critic_p),
                              optims[2].init(dual_params(log_temperature, log_alpha)))
    update_batch = int(config.arch.get("update_batch_size", 1))
    buffer = replay_buffer(config, 8)
    search = SMCSearch(make_simulator(config), apply_fns, config, continuous,
                       action_dim(env, continuous))
    item = dummy_item(env, continuous, search.num_particles, device)
    learner = SearchReplayLearner(env, buffer, config,
                                  SPOUpdate(apply_fns, optims, config, continuous),
                                  SPOActing(search))
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    state = OffPolicyLearnerState(
        params=anakin.broadcast_to_update_batch(params, update_batch),
        opt_states=anakin.broadcast_to_update_batch(opt_states, update_batch),
        buffer_state=anakin.join_per_replica([buffer.init(item) for _ in range(update_batch)]),
        generator=anakin.make_step_generators(step_seed, device, update_batch),
        env_state=env_state, timestep=timestep)
    return AnakinSetup(
        learn=learner, learner_state=state,
        eval_act_fn=get_distribution_act_fn(config, apply_fns[0]),
        eval_params_fn=lambda s: anakin.split_replicas(
            s.params, update_batch)[0].actor_params.online)


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin SPO; returns the final evaluation episode-return mean.
    Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_spo.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
