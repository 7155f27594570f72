"""Anakin Disco-RL, disco103 (counterpart of
stoix_tpu/systems/disco/ff_disco103.py): an agent whose per-step loss comes
from the Disco update rule (systems/disco/update_rule.py), with a meta-state
(the EMA target params) carried through every minibatch; the meta-params are
fixed, never trained.

One update step, in the JAX package's order (ff_disco103.py:92-181):

  1. rollout: `rollout_length` env steps, each action drawn from the
     Categorical of the agent's logits with the replica's generator; each
     step stores done, truncated, action, reward, obs, the episode info and
     all five of the agent's heads;
  2. `epochs` times: a permutation of each replica's ENVS from its
     generator, then `num_minibatches` minibatches of whole [T, E_u / M]
     env columns (time stays contiguous for the rule): the agent's outputs
     on the minibatch, the rule's loss over rewards[:-1] and done[:-1] (its
     mean over [T, E]), the new meta-state; the gradients averaged over the
     replicas, then the data ranks, in one all-reduce; each element clipped
     to `max_abs_update` and an Adam step (eps 1e-5).

The targets are one-step, so no B1 recurrence runs on this path (nor in the
JAX package). The evaluator acts on Categorical(logits). The envs a rank
holds must divide into `num_minibatches` (ValueError otherwise, as the JAX
package). The JAX ff_disco103 does not read `system.update_guard`; the port
refuses it (ROADMAP C22).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ExperimentOutput
from stoix_tpu_torch.evaluator import get_distribution_act_fn
from stoix_tpu_torch.networks.disco import DiscoAgentNetwork, DiscoAgentOutput
from stoix_tpu_torch.ops import distributions as dists
from stoix_tpu_torch.parallel import is_coordinator
from stoix_tpu_torch.systems import anakin, off_policy_core as core
from stoix_tpu_torch.systems.ddpg.ff_ddpg import join_metrics, refuse_ignored_knobs
from stoix_tpu_torch.systems.disco.update_rule import (
    DiscoUpdateRule, MetaState, UpdateRuleInputs, get_logger, load_meta_params,
)
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import _cat, make_apply_fn
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ElementClipAdam, apply_updates, make_learning_rate
from stoix_tpu_torch.utils.tree import tree_map, tree_stack

Params = Dict[str, torch.Tensor]


class DiscoTransition(NamedTuple):
    done: torch.Tensor
    truncated: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    obs: Any
    info: Any
    agent_out: DiscoAgentOutput


class DiscoLearnerState(NamedTuple):
    params: Any  # every tensor [U, ...] when arch.update_batch_size U > 1
    opt_states: Any  # likewise
    generator: Any  # actions and shuffles: a torch.Generator, or a tuple of one a replica
    env_state: Any
    timestep: envs.TimeStep
    meta_state: MetaState  # [U, ...] likewise


def batched_apply(apply_fn: Callable, params: Params, observations: Any) -> DiscoAgentOutput:
    """The agent over [T, E, ...] observations in one call on the [T.E] rows."""
    lead = observations.agent_view.shape[:2]
    flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), observations)
    return DiscoAgentOutput(*(x.reshape(tuple(lead) + tuple(x.shape[1:]))
                              for x in apply_fn(params, flat)))


def draw_actions(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """A Categorical(logits) sample from its Gumbel draws (`jax.random.categorical`)."""
    return (dists.Categorical(logits).logits + gumbel).argmax(-1)


class DiscoLearner:
    """`learner(state) -> ExperimentOutput` runs `arch.num_updates_per_eval`
    update steps; `rollout`, `update` and `update_minibatch` are its parts."""

    def __init__(self, env: envs.Environment, apply_fn: Callable, optim: ElementClipAdam,
                 rule: DiscoUpdateRule, meta_params: Params, config: Any):
        self.env = env
        self.apply_fn = apply_fn
        self.optim = optim
        self.rule = rule
        self.meta_params = meta_params
        system = config.system
        self.hyperparams = dict(system.get("disco_hyperparams", {}) or {})
        self.hyperparams.setdefault("gamma", float(system.gamma))
        self.reward_scale = float(system.get("reward_scale", 1.0))
        self.rollout_length = int(system.rollout_length)
        self.epochs = int(system.epochs)
        self.num_minibatches = int(system.num_minibatches)
        self.num_updates_per_eval = int(config.arch.num_updates_per_eval)
        self.update_batch = int(config.arch.get("update_batch_size", 1))
        self.data_group = anakin.data_group()

    def group(self, tree: Any, index: int, dim: int) -> Any:
        return anakin.env_group(tree, index, self.update_batch, dim)

    def unroll(self, params: Params, observations: Any) -> DiscoAgentOutput:
        return batched_apply(self.apply_fn, params, observations)

    @torch.no_grad()
    def rollout(self, state: DiscoLearnerState, gumbels: Optional[torch.Tensor] = None
                ) -> Tuple[DiscoLearnerState, DiscoTransition]:
        """`rollout_length` env steps, stacked to [T, E, ...]; the actions
        from `gumbels` [T, E, A] when given, else each replica's generator."""
        params = anakin.split_replicas(state.params, self.update_batch)
        generators = anakin.per_replica(state.generator, self.update_batch)
        env_state, timestep = state.env_state, state.timestep
        steps = []
        for step in range(self.rollout_length):
            observation = timestep.observation
            outs, actions = [], []
            for u, (p, generator) in enumerate(zip(params, generators)):
                out = self.apply_fn(p, self.group(observation, u, 0))
                actions.append(dists.Categorical(out.logits).sample(generator) if gumbels is None
                               else draw_actions(out.logits,
                                                 self.group(gumbels[step], u, 0)))
                outs.append(out)
            agent_out = DiscoAgentOutput(*(_cat(parts, 0) for parts in zip(*outs)))
            action = _cat(actions, 0)
            env_state, timestep = self.env.step(env_state, action)
            steps.append(DiscoTransition(
                done=timestep.discount == 0.0,
                truncated=timestep.last() & (timestep.discount != 0.0),
                action=action, reward=timestep.reward, obs=observation,
                info=timestep.extras["episode_metrics"], agent_out=agent_out))
        return state._replace(env_state=env_state, timestep=timestep), tree_stack(steps)

    def loss(self, params: Params, minibatch: DiscoTransition, meta_state: MetaState):
        """The rule's mean per-step loss on a [T, E_mb] minibatch (ff_disco103.py:117-131)."""
        inputs = UpdateRuleInputs(
            observations=minibatch.obs, actions=minibatch.action,
            rewards=minibatch.reward[:-1] * self.reward_scale,
            is_terminal=minibatch.done[:-1],
            agent_out=self.unroll(params, minibatch.obs),
            behaviour_agent_out=minibatch.agent_out)
        loss_per_step, new_meta_state, logs = self.rule(
            self.meta_params, params, inputs, self.hyperparams, meta_state, self.unroll)
        return torch.mean(loss_per_step), (new_meta_state, logs)

    def update_minibatch(self, params: List[Params], opt_states: List[Any],
                         meta_states: List[MetaState], batches: Sequence[DiscoTransition]):
        grads, new_metas, logs = [], [], []
        for p, meta, batch in zip(params, meta_states, batches):
            g, (new_meta, log) = core.value_and_grad(self.loss, p, batch, meta)
            grads.append(g)
            new_metas.append(new_meta)
            logs.append(log)
        grads = anakin.data_mean(anakin.mean_gradients(grads), self.data_group)
        new_params, new_opts = [], []
        for p, opt in zip(params, opt_states):
            updates, opt = self.optim.update(grads, opt)
            new_params.append(apply_updates(p, updates))
            new_opts.append(opt)
        return new_params, new_opts, new_metas, join_metrics(logs)

    def update(self, params: Any, opt_states: Any, meta_state: Any, traj: DiscoTransition,
               generator: Any = None, permutations: Optional[Sequence[Any]] = None
               ) -> Tuple[Any, Any, Any, Dict[str, torch.Tensor]]:
        """`epochs` x `num_minibatches` minibatch steps over one [T, E]
        trajectory. Each epoch shuffles every replica's envs with
        `permutations[epoch]` when given (a tensor at U = 1, else one a
        replica), else with a permutation from the replica's generator."""
        replica_params = anakin.split_replicas(params, self.update_batch)
        replica_opts = anakin.split_replicas(opt_states, self.update_batch)
        replica_metas = anakin.split_replicas(meta_state, self.update_batch)
        generators = ([None] * self.update_batch if generator is None
                      else anakin.per_replica(generator, self.update_batch))
        samples = [self.group(traj._replace(info=None), u, 1) for u in range(self.update_batch)]
        num_envs = traj.reward.shape[1] // self.update_batch
        size = num_envs // self.num_minibatches
        per_epoch = []
        for epoch in range(self.epochs):
            shuffled = []
            for u, sample in enumerate(samples):
                if permutations is not None:
                    given = permutations[epoch]
                    permutation = (given if self.update_batch == 1 else given[u]).to(
                        traj.reward.device)
                else:
                    permutation = torch.randperm(num_envs, generator=generators[u],
                                                 device=traj.reward.device)
                shuffled.append(tree_map(lambda x: x.index_select(1, permutation), sample))
            per_minibatch = []
            for i in range(self.num_minibatches):
                batches = [tree_map(lambda x: x[:, i * size:(i + 1) * size], s) for s in shuffled]
                replica_params, replica_opts, replica_metas, info = self.update_minibatch(
                    replica_params, replica_opts, replica_metas, batches)
                per_minibatch.append(info)
            per_epoch.append(tree_stack(per_minibatch))
        return (anakin.join_replicas(replica_params), anakin.join_replicas(replica_opts),
                anakin.join_replicas(replica_metas), tree_stack(per_epoch))

    def update_step(self, state: DiscoLearnerState) -> Tuple[DiscoLearnerState, Tuple]:
        state, traj = self.rollout(state)
        params, opt_states, meta_state, metrics = self.update(
            state.params, state.opt_states, state.meta_state, traj, state.generator)
        return (state._replace(params=params, opt_states=opt_states, meta_state=meta_state),
                (traj.info, metrics))

    def __call__(self, state: DiscoLearnerState) -> ExperimentOutput:
        episode_info, loss_info = [], []
        for _ in range(self.num_updates_per_eval):
            state, (episodes, losses_) = self.update_step(state)
            episode_info.append(episodes)
            loss_info.append(losses_)
        return ExperimentOutput(state, tree_stack(episode_info), anakin.data_mean(
            tree_stack(loss_info), self.data_group, kind="metrics"))


def check_minibatches(config: Any) -> None:
    """The envs a rank holds must divide into `num_minibatches` (minibatches are over envs)."""
    envs_per_shard = int(config.arch.total_num_envs) // anakin.data_rank_and_size()[1]
    if envs_per_shard % int(config.system.num_minibatches) != 0:
        raise ValueError(
            f"disco minibatches are over envs: arch.total_num_envs/shards "
            f"({envs_per_shard}) must be divisible by system.num_minibatches "
            f"({config.system.num_minibatches})")


def make_rule(config: Any, num_actions: int, device: Any) -> DiscoUpdateRule:
    system = config.system
    return DiscoUpdateRule(
        num_actions=num_actions, num_bins=int(system.get("num_bins", 51)),
        vmax=float(system.get("vmax", 500.0)), mode=str(system.get("rule_mode", "grounded")),
        target_ema=float(system.get("target_ema", 0.99)),
        policy_temperature=float(system.get("policy_temperature", 0.5)), device=device)


def build_network(env: envs.Environment, config: Any, generator: torch.Generator,
                  num_bins: int) -> DiscoAgentNetwork:
    """The agent of `network.agent_network`, each module taking its input
    width from the one before it; the weights draw from `generator`."""
    cfg = config.network.agent_network
    num_actions = int(env.num_actions)
    in_dim = int(env.observation_value().agent_view.shape[-1])
    torso = config_lib.instantiate(cfg.shared_torso, input_dim=in_dim, generator=generator)
    conditional = config_lib.instantiate(cfg.action_conditional_torso, num_actions=num_actions,
                                         input_dim=torso.output_dim, generator=generator)

    def head(key: str, width: int, output_dim: int):
        return config_lib.instantiate(cfg[key], output_dim=output_dim, input_dim=width,
                                      generator=generator)

    return DiscoAgentNetwork(
        torso, conditional, head("logits_head", torso.output_dim, num_actions),
        head("q_head", conditional.output_dim, num_bins),
        head("y_head", torso.output_dim, num_bins),
        head("z_head", conditional.output_dim, num_bins),
        head("aux_pi_head", conditional.output_dim, num_actions))


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    """The rule and its meta-params (the npz at `system.meta_params_path`, or
    random), the agent (initialised on the CPU from `seed`, then moved to
    `device`), the elementwise clip + Adam, the learner and its initial state."""
    refuse_ignored_knobs(config, str(config.system.system_name))
    num_actions = int(env.num_actions)
    config.system.action_dim = num_actions
    check_minibatches(config)
    rule = make_rule(config, num_actions, device)
    init_seed, meta_seed, env_seed, step_seed = anakin.make_seeds(seed, 4)
    network = build_network(env, config, anakin.make_generator(init_seed, torch.device("cpu")),
                            rule.num_bins)
    network.to(device)
    apply_fn = make_apply_fn(network)
    epochs, minibatches = int(config.system.epochs), int(config.system.num_minibatches)
    optim = ElementClipAdam(make_learning_rate(float(config.system.lr), config, epochs,
                                               minibatches),
                            float(config.system.get("max_abs_update", 1.0)), eps=1e-5)
    meta_params, pretrained = load_meta_params(
        rule, anakin.make_generator(meta_seed, torch.device("cpu")),
        config.system.get("meta_params_path"))
    if rule.mode == "meta" and not pretrained and is_coordinator():
        get_logger().warning("[disco] WARNING: meta mode with random meta-params: the machinery "
                             "runs but the targets are uninformative")
    params = {k: v.detach() for k, v in network.named_parameters()}
    update_batch = int(config.arch.get("update_batch_size", 1))
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    state = DiscoLearnerState(
        params=anakin.broadcast_to_update_batch(params, update_batch),
        opt_states=anakin.broadcast_to_update_batch(optim.init(params), update_batch),
        generator=anakin.make_step_generators(step_seed, device, update_batch),
        env_state=env_state, timestep=timestep,
        meta_state=anakin.broadcast_to_update_batch(rule.init_meta_state(params), update_batch))

    def eval_apply(p: Params, observation: Any) -> dists.Categorical:
        return dists.Categorical(apply_fn(p, observation).logits)

    return AnakinSetup(
        learn=DiscoLearner(env, apply_fn, optim, rule, meta_params, config),
        learner_state=state, eval_act_fn=get_distribution_act_fn(config, eval_apply),
        eval_params_fn=lambda s: anakin.split_replicas(s.params, update_batch)[0])


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin Disco-RL (disco103); returns the final evaluation
    episode-return mean. Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_disco103.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
