"""Anakin recurrent PPO (counterpart of stoix_tpu/systems/ppo/anakin/rec_ppo.py
on its single-device path): an actor and a critic that each run
pre_torso -> ScannedRNN (GRU or LSTM) -> post_torso -> head over time.

One update step, in the JAX package's order:

  1. rollout: `rollout_length` steps; at each, both RNNs take one step from
     their carries, reset first where the previous step ended an episode
     (`entering_done`, termination or truncation); the transition stores the
     carries at the START of the step, and the bootstrap value of the true
     next observation, read by the critic from its post-step carry with
     `done` zero (that read does not advance the carry);
  2. with `system.normalize_observations`, the trajectory's observations
     normalised with the pre-update statistics, then the raw ones folded in;
  3. truncation-aware GAE from the stored bootstrap values, in one launch of
     B1's GAE entry point under `system.multistep_impl: pallas`;
  4. `epochs` times: a permutation of the ENVS (time stays contiguous), then
     `num_minibatches` clipped-PPO updates, each re-unrolling the actor and
     the critic over the minibatch's [T, E/M] sequences from their stored
     carries at t = 0 with the rollout's reset flags, then a global-norm clip
     + Adam step on each side.

`arch.update_batch_size` U > 1 runs U replicas as ff_ppo's learner does
(ff_ppo.py): a Python loop over replica u's env columns u.E to (u+1).E of
every tensor, carries included, with the gradients averaged over the
replicas, and one GAE launch over the whole [T, U.E] trajectory.

The JAX package's rec_ppo reads none of ff_ppo's `system.update_guard`,
`fused_update`, `adaptive_kl_beta` or `reward_scale` (it ignores them,
ROADMAP C12); the port refuses each, naming it.

Launches: every minibatch re-unrolls two cells one time step at a time, so
an update at the default width takes thousands of launches from Python
(PERF.md §5).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.func import functional_call

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ActorCriticParams, RNNLearnerState
from stoix_tpu_torch.networks.base import RecurrentActor, RecurrentCritic, ScannedRNN
from stoix_tpu_torch.ops import losses, running_statistics, truncated_generalized_advantage_estimation
from stoix_tpu_torch.systems import anakin
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import (
    PPOLearner,
    UpdateResult,
    _leaf_copies,
    initial_train_state,
    make_optimizers,
)
from stoix_tpu_torch.systems.runner import AnakinSetup, run_rnn_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam
from stoix_tpu_torch.utils.tree import tree_map, tree_stack

# ff_ppo's knobs the JAX package's rec_ppo does not read (ROADMAP C12).
_IGNORED_BY_THE_REFERENCE = (
    ("update_guard", "system.update_guard", "off"),
    ("fused_update", "system.fused_update", False),
    ("adaptive_kl_beta", "system.adaptive_kl_beta", False),
    ("reward_scale", "system.reward_scale", 1.0),
)


def check_ported_system(config: Any) -> None:
    """Raise NotImplementedError, naming each key, for an ff_ppo knob set
    away from its default that the JAX package's rec_ppo ignores: the port
    does not apply it silently either."""
    system = config.system
    refused = [name for key, name, default in _IGNORED_BY_THE_REFERENCE
               if system.get(key, default) not in (default, None, False, "off")]
    if refused:
        raise NotImplementedError(
            "not ported for rec_ppo (the JAX package's rec_ppo ignores it): "
            + ", ".join(refused))


class RNNPPOTransition(NamedTuple):
    done: torch.Tensor
    truncated: torch.Tensor
    entering_done: torch.Tensor  # the reset flag fed to the RNNs at this step
    action: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    bootstrap_value: torch.Tensor
    log_prob: torch.Tensor
    obs: Any
    hstates: Tuple[Any, Any]  # (actor, critic) carries at the START of the step
    info: Dict[str, Any]


def _cat(parts: Sequence[Any]) -> Any:
    """The replicas' trees joined along the env axis (dim 0)."""
    return parts[0] if len(parts) == 1 else tree_map(lambda *xs: torch.cat(xs, 0), *parts)


def _step_input(tree: Any) -> Any:
    """One time step as a length-1 time-major sequence."""
    return tree_map(lambda x: x[None], tree)


class RecPPOLearner(PPOLearner):
    """ff_ppo's learner (its replicas, the minibatch step with the replicas'
    gradient mean and clip + Adam, advantage standardisation, the statistics
    fold) over sequences: its own rollout, GAE from the stored bootstrap
    values, env-axis minibatches and re-unrolled losses."""

    def __init__(self, env: envs.Environment, apply_fns: Tuple[Callable, Callable],
                 update_fns: Tuple[ClipAdam, ClipAdam], config: Any):
        check_ported_system(config)
        super().__init__(env, apply_fns, update_fns, config)

    # ------------------------------------------------------------ rollout

    def _act(self, params: List[ActorCriticParams], generators: Sequence[Any], observation: Any,
             reset: torch.Tensor, hstates: Tuple[Any, Any]):
        """One RNN step of each replica on its envs: (action, value, log-prob,
        new actor carry, new critic carry) over every env."""
        outs = []
        for u, (p, generator) in enumerate(zip(params, generators)):
            inputs = (_step_input(self.group(observation, u, 0)), self.group(reset, u, 0)[None])
            actor_h, policy = self.actor_apply(p.actor_params, self.group(hstates[0], u, 0),
                                               inputs)
            critic_h, value = self.critic_apply(p.critic_params, self.group(hstates[1], u, 0),
                                                inputs)
            action = policy.sample(generator)
            outs.append((action[0], value[0], policy.log_prob(action)[0], actor_h, critic_h))
        return tuple(_cat(parts) for parts in zip(*outs))

    def _bootstrap(self, params: List[ActorCriticParams], next_obs: Any,
                   critic_h: Any) -> torch.Tensor:
        """Each replica's value of the true next observation from the
        post-step critic carry, with no reset; the carry is not kept."""
        values = []
        for u, p in enumerate(params):
            x = _step_input(self.group(next_obs, u, 0))
            h = self.group(critic_h, u, 0)
            no_reset = torch.zeros(x.agent_view.shape[:2], dtype=torch.bool,
                                   device=x.agent_view.device)
            values.append(self.critic_apply(p.critic_params, h, (x, no_reset))[1][0])
        return _cat(values)

    @torch.no_grad()
    def rollout(self, state: RNNLearnerState) -> Tuple[RNNLearnerState, RNNPPOTransition]:
        """`rollout_length` env steps; the transitions stacked to [T, E, ...],
        observations raw."""
        params, generators = self.replicas(state.params), self.generators(state.generator)
        env_state, timestep = state.env_state, state.timestep
        done, truncated, hstates = state.done, state.truncated, state.hstates
        transitions = []
        for _ in range(self.rollout_length):
            reset = done | truncated
            observation = timestep.observation
            action, value, log_prob, actor_h, critic_h = self._act(
                params, generators, self.normalized(observation, state.obs_stats), reset,
                hstates)
            env_state, timestep = self.env.step(env_state, action)
            done = timestep.discount == 0.0
            truncated = timestep.last() & (timestep.discount != 0.0)
            bootstrap = self._bootstrap(
                params, self.normalized(timestep.extras["next_obs"], state.obs_stats), critic_h)
            transitions.append(RNNPPOTransition(
                done=done,
                truncated=truncated,
                entering_done=reset,
                action=action,
                value=value,
                reward=timestep.reward,
                bootstrap_value=bootstrap,
                log_prob=log_prob,
                obs=observation,
                hstates=hstates,
                info=timestep.extras["episode_metrics"],
            ))
            hstates = (actor_h, critic_h)
        state = state._replace(env_state=env_state, timestep=timestep, done=done,
                               truncated=truncated, hstates=hstates)
        return state, tree_stack(transitions)

    # ------------------------------------------------------------ update

    def loss_info(self, loss_actor: torch.Tensor, value_loss: torch.Tensor,
                  entropy: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"actor_loss": loss_actor, "value_loss": value_loss, "entropy": entropy}

    def gradients(self, params: ActorCriticParams, batch: Tuple, behavior_params: Any,
                  kl_beta: Any):
        """One replica's actor and critic gradients on one minibatch of
        [T, E/M] sequences, each network re-unrolled from its stored carry
        at t = 0 with the rollout's reset flags."""
        del behavior_params, kl_beta
        obs, action, old_log_prob, old_value, entering_done, hstates, advantages, targets = batch
        actor_h0, critic_h0 = (tree_map(lambda x: x[0], h) for h in hstates)
        with torch.enable_grad():
            actor_params = _leaf_copies(params.actor_params)
            _, policy = self.actor_apply(actor_params, actor_h0, (obs, entering_done))
            loss_actor = losses.ppo_clip_loss(policy.log_prob(action), old_log_prob, advantages,
                                              self.clip_eps)
            entropy = policy.entropy().mean()
            actor_grads = dict(zip(actor_params, torch.autograd.grad(
                loss_actor - self.ent_coef * entropy, list(actor_params.values()))))
            critic_params = _leaf_copies(params.critic_params)
            _, value = self.critic_apply(critic_params, critic_h0, (obs, entering_done))
            if self.clip_value:
                value_loss = losses.clipped_value_loss(value, old_value, targets, self.clip_eps)
            else:
                value_loss = torch.mean((value - targets) ** 2)
            critic_grads = dict(zip(critic_params, torch.autograd.grad(
                self.vf_coef * value_loss, list(critic_params.values()))))
        return actor_grads, critic_grads, (loss_actor.detach(), value_loss.detach(),
                                           entropy.detach())

    def update(self, params: ActorCriticParams, opt_states: Any, traj_batch: RNNPPOTransition,
               generator: Any = None, permutations: Optional[Sequence[Any]] = None,
               kl_beta: Any = None) -> UpdateResult:
        """GAE, then epochs x minibatches of PPO updates on one [T, E]
        trajectory of sequences (observations as the networks take them).
        Each epoch shuffles every replica's envs with `permutations[epoch]`
        when given (a tensor at U = 1, else one a replica), else with a
        permutation drawn from the replica's generator."""
        replica_params, replica_opt = self.replicas(params), self.replicas(opt_states)
        generators = self.generators(generator)
        with torch.no_grad():
            advantages, targets = truncated_generalized_advantage_estimation(
                traj_batch.reward,
                self.gamma * (1.0 - traj_batch.done.to(torch.float32)),
                self.gae_lambda,
                v_tm1=traj_batch.value,
                v_t=traj_batch.bootstrap_value,
                truncation_t=traj_batch.truncated.to(torch.float32),
                standardize_advantages=self.standardize_advantages and self.update_batch == 1,
                impl=self.multistep_impl,
            )
            if self.standardize_advantages and self.update_batch > 1:
                advantages = self.standardized(advantages)

        samples = (traj_batch.obs, traj_batch.action, traj_batch.log_prob, traj_batch.value,
                   traj_batch.entering_done, traj_batch.hstates, advantages, targets)
        per_replica = [self.group(samples, u, 1) for u in range(self.update_batch)]
        num_envs = advantages.shape[1] // self.update_batch
        m = self.num_minibatches
        per_epoch = []
        for epoch in range(self.epochs):
            minibatches = []
            for u in range(self.update_batch):
                if permutations is not None:
                    given = permutations[epoch]
                    permutation = (given if self.update_batch == 1 else given[u]).to(
                        advantages.device)
                else:
                    permutation = torch.randperm(num_envs, generator=generators[u],
                                                 device=advantages.device)
                # Envs shuffled, then split into M contiguous groups: [T, M, E/M, ...].
                minibatches.append(tree_map(
                    lambda x: x.index_select(1, permutation).reshape(
                        (x.shape[0], m, -1) + x.shape[2:]),
                    per_replica[u],
                ))
            per_minibatch = []
            for i in range(m):
                batches = [tree_map(lambda x: x[:, i], mb) for mb in minibatches]
                replica_params, replica_opt, info = self._update_minibatch(
                    replica_params, replica_opt, batches, [None] * self.update_batch, None)
                per_minibatch.append(info)
            per_epoch.append(tree_stack(per_minibatch))
        return UpdateResult(self.join(replica_params), self.join(replica_opt),
                            tree_stack(per_epoch), advantages, targets)

    def update_step(self, state: RNNLearnerState):
        state, traj_batch = self.rollout(state)
        if self.normalize_obs:
            # Normalise with the PRE-update statistics (what the rollout's
            # log-probs, values and carries used, so the re-unrolls match the
            # behaviour policy), THEN fold the raw observations in.
            raw = traj_batch.obs
            traj_batch = traj_batch._replace(
                obs=running_statistics.normalize_observation(raw, state.obs_stats))
            state = state._replace(obs_stats=self.folded_statistics(state.obs_stats, raw))
        result = self.update(state.params, state.opt_states, traj_batch, state.generator)
        state = state._replace(params=result.params, opt_states=result.opt_states)
        return state, (traj_batch.info, result.loss_info)


def get_learner_fn(env: envs.Environment, apply_fns: Tuple[Callable, Callable],
                   update_fns: Tuple[ClipAdam, ClipAdam], config: Any) -> RecPPOLearner:
    return RecPPOLearner(env, apply_fns, update_fns, config)


def make_apply_fn(network: torch.nn.Module) -> Callable[[Dict[str, torch.Tensor], Any, Any], Any]:
    """`apply(params, hstate, (observation, done))`: the recurrent network
    with `params` swapped in."""
    return lambda params, hstate, inputs: functional_call(network, params, (hstate, inputs))


def rnn_width(config: Any) -> Tuple[int, str]:
    """(`network.rnn_hidden_size`, `network.rnn_cell_type`)."""
    return (int(config.network.get("rnn_hidden_size", 128)),
            str(config.network.get("rnn_cell_type", "gru")))


def build_networks(env: envs.Environment, config: Any, generator: torch.Generator
                   ) -> Tuple[RecurrentActor, RecurrentCritic]:
    """The recurrent actor and critic from the network config; each module
    takes its input width from the one before it, the weights draw from
    `generator`."""
    net_cfg = config.network
    hidden_size, cell_type = rnn_width(config)
    dummy_obs = env.observation_value()

    def parts(cfg: Any, head_key: str, head_kwargs: dict):
        input_layer = config_lib.instantiate(cfg.input_layer)
        in_dim = int(input_layer(dummy_obs).shape[-1])
        pre_torso = config_lib.instantiate(cfg.pre_torso, input_dim=in_dim, generator=generator)
        rnn = ScannedRNN(pre_torso.output_dim, hidden_size, cell_type, generator=generator)
        post_torso = config_lib.instantiate(cfg.post_torso, input_dim=hidden_size,
                                            generator=generator)
        head = config_lib.instantiate(cfg[head_key], input_dim=post_torso.output_dim,
                                      generator=generator, **head_kwargs)
        return head, rnn, pre_torso, post_torso, input_layer

    actor_cfg = net_cfg.actor_network
    actor = RecurrentActor(*parts(actor_cfg, "action_head",
                                  anakin.head_kwargs_for_env(actor_cfg.action_head, env)))
    critic = RecurrentCritic(*parts(net_cfg.critic_network, "critic_head", {}))
    return actor, critic


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    """Build the networks (initialised on the CPU from `seed`, then moved to
    `device`), the optimizers, the learner and its initial state: every env's
    carries fresh (zeros) and its reset flags clear."""
    config.system.action_dim = env.num_actions
    hidden_size, cell_type = rnn_width(config)
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)

    actor_network, critic_network = build_networks(
        env, config, anakin.make_generator(init_seed, torch.device("cpu")))
    actor_network.to(device)
    critic_network.to(device)
    optims = make_optimizers(config)
    actor_apply, critic_apply = make_apply_fn(actor_network), make_apply_fn(critic_network)
    learner = get_learner_fn(env, (actor_apply, critic_apply), optims, config)
    params, opt_states, generator = initial_train_state(
        actor_network, critic_network, optims, config, device, step_seed)

    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    num_envs = timestep.reward.shape[0]  # this rank's envs

    def fresh_carry() -> Any:
        return ScannedRNN.initialize_carry(cell_type, hidden_size, (num_envs,), device)

    learner_state = RNNLearnerState(
        params=params,
        opt_states=opt_states,
        generator=generator,
        env_state=env_state,
        timestep=timestep,
        done=torch.zeros((num_envs,), dtype=torch.bool, device=device),
        truncated=torch.zeros((num_envs,), dtype=torch.bool, device=device),
        hstates=(fresh_carry(), fresh_carry()),
        obs_stats=running_statistics.init_state(env.observation_value().agent_view.to(device)),
    )

    greedy = bool(config.arch.get("evaluation_greedy", False))
    normalize_obs = learner.normalize_obs

    def rnn_act_fn(payload, hstate, observation, done, generator):
        # One step of every eval episode; `done` resets an ended episode's carry.
        if normalize_obs:
            actor_params, stats = payload
            observation = running_statistics.normalize_observation(observation, stats)
        else:
            actor_params = payload
        hstate, policy = actor_apply(actor_params, hstate, (_step_input(observation), done[None]))
        action = policy.mode() if greedy else policy.sample(generator)
        return hstate, action[0]

    if normalize_obs:
        eval_params_fn = lambda s: (learner.eval_params(s.params), s.obs_stats)  # noqa: E731
    else:
        eval_params_fn = lambda s: learner.eval_params(s.params)  # noqa: E731
    return AnakinSetup(learn=learner, learner_state=learner_state, eval_act_fn=rnn_act_fn,
                       eval_params_fn=eval_params_fn)


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin recurrent PPO; returns the final evaluation episode-return
    mean. Runs on CUDA unless the caller asks for another device."""
    return run_rnn_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_rec_ppo.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
