"""Shared Anakin skeleton for the value-based (DQN) family (counterpart of
stoix_tpu/systems/q_learning/q_family.py).

Each system file supplies a `QLossFn` and head kwargs; the buffer, the
warmup fill, the rollout and the update loop come from off_policy_core. The
update of one sampled batch: the loss's gradients with respect to the online
params (averaged over the replicas, then over the data ranks, the JAX
package's `pmean_grads`), a global-norm clip and Adam (eps 1e-5),
the Polyak target update `tau . online + (1 - tau) . target`, and the
divergence guard under `system.update_guard`. Acting is epsilon-greedy; with
`system.epsilon_decay_steps` epsilon decays linearly from
`training_epsilon` to `final_epsilon` over that many items added to the
replica's buffer (its host count `num_added`, so nothing syncs).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import OffPolicyLearnerState, OnlineAndTarget, Transition
from stoix_tpu_torch.evaluator import get_distribution_act_fn
from stoix_tpu_torch.resilience import guards
from stoix_tpu_torch.systems import anakin, off_policy_core as core
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import (
    ClipAdam, apply_updates, incremental_update, make_learning_rate,
)
from stoix_tpu_torch.utils.tree import tree_leaves, tree_stack

# (online_params, target_params, batch, q_apply, config) -> (loss, metrics)
QLossFn = Callable[[Any, Any, Transition, Callable, Any], Tuple[torch.Tensor, Dict]]


def act_dist(apply_out: Any):
    """The distribution of a head's output (plain heads return it; the
    distributional heads return (dist, logits or quantiles, atoms or taus))."""
    return apply_out[0] if isinstance(apply_out, tuple) else apply_out


def get_discrete_warmup_fn(learner: core.OffPolicyLearner, config: Any
                           ) -> Callable[[OffPolicyLearnerState], OffPolicyLearnerState]:
    """The learner's rollout for `system.warmup_steps` steps of every env, on
    uniform-random discrete actions, each replica's drawn from its generator,
    added to its buffer."""
    action_dim = int(config.system.action_dim)

    def uniform(params: Any, observation: Any, generator: torch.Generator,
                buffer_state: Any) -> torch.Tensor:
        group = tree_leaves(observation)[0].shape[0]
        return torch.randint(0, action_dim, (group,), generator=generator, device=generator.device)

    def warmup(state: OffPolicyLearnerState) -> OffPolicyLearnerState:
        return learner.rollout(state, int(config.system.warmup_steps), uniform)[0]

    return warmup


def build_q_network(env: envs.Environment, config: Any, generator: torch.Generator,
                    **extra_head_kwargs: Any) -> torch.nn.Module:
    """FeedForwardActor(torso, Q head) from `network.actor_network`; the head
    takes the env's action count and `system.evaluation_epsilon`."""
    from stoix_tpu_torch.networks.base import FeedForwardActor

    net_cfg = config.network.actor_network
    input_layer = config_lib.instantiate(net_cfg.input_layer)
    in_dim = int(input_layer(env.observation_value()).shape[-1])
    torso = config_lib.instantiate(net_cfg.pre_torso, input_dim=in_dim, generator=generator)
    head_kwargs = dict(action_dim=env.num_actions,
                       epsilon=float(config.system.evaluation_epsilon))
    head_kwargs.update(extra_head_kwargs)
    head = config_lib.instantiate(net_cfg.action_head, input_dim=torso.output_dim,
                                  generator=generator, **head_kwargs)
    return FeedForwardActor(head, torso, input_layer)


def make_q_apply(network: torch.nn.Module) -> Callable[..., Any]:
    """`apply(params, observation, epsilon=None)`: the network with `params`."""
    return lambda params, observation, *head_args: functional_call(
        network, params, (observation, *head_args))


def epsilon_schedule(config: Any) -> Callable[[Any], Union[float, np.float32]]:
    """epsilon(buffer_state): `training_epsilon`, or with
    `system.epsilon_decay_steps` the linear decay to `final_epsilon` over that
    many added items, in float32 as the JAX package computes it. Raises the
    JAX package's ValueError for a decay that would change nothing."""
    train_eps = float(config.system.training_epsilon)
    final_eps = float(config.system.get("final_epsilon", train_eps))
    decay_steps = float(config.system.get("epsilon_decay_steps", 0) or 0)
    if decay_steps > 0 and final_eps == train_eps:
        raise ValueError(
            "system.epsilon_decay_steps is set but system.final_epsilon equals "
            "training_epsilon — the requested decay would be a no-op. Set "
            "system.final_epsilon (e.g. 0.05)."
        )

    def epsilon(buffer_state: Optional[Any]):
        if decay_steps <= 0 or buffer_state is None:
            return train_eps
        f32 = np.float32
        frac = min(f32(buffer_state.num_added) / f32(decay_steps), f32(1.0))
        return f32(train_eps) + frac * f32(final_eps - train_eps)

    return epsilon


class QUpdate:
    """`update_from_batch` of the family: every replica's loss and gradients
    on its batch, the gradients averaged, then each replica's clip + Adam step,
    Polyak target update and the guard."""

    def __init__(self, loss_fn: QLossFn, q_apply: Callable, optim: ClipAdam, config: Any):
        self.loss_fn, self.q_apply, self.optim, self.config = loss_fn, q_apply, optim, config
        self.tau = float(config.system.tau)
        self.guard_mode = guards.resolve_mode(config)
        self.data_group = anakin.data_group()

    def gradients(self, params: OnlineAndTarget, batch: Any, *loss_args: Any):
        """One replica's (gradients, loss, metrics) on its batch; `loss_args`
        follow the config in the loss's arguments."""
        with torch.enable_grad():
            online = {k: v.detach().requires_grad_(True) for k, v in params.online.items()}
            loss, info = self.loss_fn(online, params.target, batch, self.q_apply, self.config,
                                      *loss_args)
            grads = dict(zip(online, torch.autograd.grad(loss, list(online.values()))))
        return grads, loss.detach(), {k: v.detach() for k, v in info.items()}

    def __call__(self, params: List[OnlineAndTarget], opt_states: List[Any],
                 batches: List[Transition]):
        return self.step(params, opt_states, [self.gradients(p, b) for p, b in zip(params, batches)])

    def step(self, params: List[OnlineAndTarget], opt_states: List[Any], per_replica: List):
        """The replicas' gradients averaged (over the replicas, then the data
        ranks), then each replica's clip + Adam step, Polyak update and the guard."""
        grads = anakin.mean_gradients([g[0] for g in per_replica])
        if len(per_replica) == 1:
            _, loss, info = per_replica[0]
        else:
            loss = torch.stack([g[1] for g in per_replica])
            info = tree_stack([g[2] for g in per_replica])
        guard_loss = loss.mean() if self.guard_mode != "off" else None  # off adds no op
        grads, guard_loss = anakin.data_mean((grads, guard_loss), self.data_group)
        new_params, new_opt = [], []
        for p, opt in zip(params, opt_states):
            updates, opt = self.optim.update(grads, opt)
            online = apply_updates(p.online, updates)
            new_params.append(OnlineAndTarget(online, incremental_update(online, p.target,
                                                                         self.tau)))
            new_opt.append(opt)
        if self.guard_mode != "off":
            (new_params, new_opt), guard_metrics = guards.guard_update(
                self.guard_mode, new=(new_params, new_opt), old=(params, opt_states),
                loss=guard_loss, grads=(grads,))
            info = {**info, **guard_metrics}
        return new_params, new_opt, info


class PrioritisedQUpdate(QUpdate):
    """`update_from_batch` of the sequence-replay systems (ff_rainbow,
    rec_r2d2): the loss takes each replica's `PrioritisedSample` and its
    generator, `loss_fn(online, target, sample, q_apply, config, generator)
    -> (loss, metrics)`, with the sample's new priorities under the metrics'
    "priorities" key, which are returned a replica, not averaged into the
    metrics."""

    def __call__(self, params: List[OnlineAndTarget], opt_states: List[Any],
                 samples: List[Any], generators: List[torch.Generator]):
        per_replica = [self.gradients(p, s, g) for p, s, g in zip(params, samples, generators)]
        priorities = [info.pop("priorities") for _, _, info in per_replica]
        return (*self.step(params, opt_states, per_replica), priorities)


def refuse_ignored_knobs(config: Any, system_name: str) -> None:
    """Raise NotImplementedError, naming the key, for `system.update_guard`
    set away from off in a system whose JAX counterpart does not read it
    (ff_rainbow, rec_r2d2): the port does not apply it silently either."""
    if guards.resolve_mode(config) != "off":
        raise NotImplementedError(f"not ported for {system_name} (the JAX package's "
                                  f"{system_name} ignores it): system.update_guard")


def q_learner_setup(
    env: envs.Environment, config: Any, device: torch.device, seed: int, loss_fn: QLossFn,
    head_kwargs: Optional[Dict[str, Any]] = None,
) -> Tuple[AnakinSetup, Callable]:
    """The Q-network (initialised on the CPU from `seed`, then moved to
    `device`), clip + Adam, the buffers, the learner and its initial state;
    returns (setup, warmup)."""
    config.system.action_dim = env.num_actions
    epsilon = epsilon_schedule(config)
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)
    update_batch = int(config.arch.get("update_batch_size", 1))

    q_network = build_q_network(env, config, anakin.make_generator(init_seed,
                                                                   torch.device("cpu")),
                                **(head_kwargs or {}))
    q_network.to(device)
    q_apply = make_q_apply(q_network)
    optim = ClipAdam(make_learning_rate(float(config.system.q_lr), config,
                                        int(config.system.epochs)),
                     float(config.system.max_grad_norm), eps=1e-5)
    online = {k: v.detach() for k, v in q_network.named_parameters()}

    buffer, buffer_state = core.build_buffer(env, config, device, discrete_actions=True)
    buffer_states = [buffer_state] + [
        buffer.init(core.dummy_transition(env, True, device)) for _ in range(update_batch - 1)]

    def act_in_env(params: OnlineAndTarget, observation: Any, generator: torch.Generator,
                   buffer_state: Any = None) -> torch.Tensor:
        dist = act_dist(q_apply(params.online, observation, epsilon(buffer_state)))
        return dist.sample(generator)

    learner = core.OffPolicyLearner(
        env, buffer, config, QUpdate(loss_fn, q_apply, optim, config), act_in_env)
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    learner_state = OffPolicyLearnerState(
        params=anakin.broadcast_to_update_batch(OnlineAndTarget(online, online), update_batch),
        opt_states=anakin.broadcast_to_update_batch(optim.init(online), update_batch),
        buffer_state=anakin.join_per_replica(buffer_states),
        generator=anakin.make_step_generators(step_seed, device, update_batch),
        env_state=env_state,
        timestep=timestep,
    )
    warmup = get_discrete_warmup_fn(learner, config)

    def eval_apply(params, observation):
        return act_dist(q_apply(params, observation))

    setup = AnakinSetup(
        learn=learner,
        learner_state=learner_state,
        eval_act_fn=get_distribution_act_fn(config, eval_apply),
        eval_params_fn=lambda s: anakin.split_replicas(s.params, update_batch)[0].online,
    )
    return setup, warmup


def run_q_experiment(config: Any, loss_fn: QLossFn,
                     head_kwargs: Optional[Dict[str, Any]] = None,
                     device: Union[str, torch.device] = "cuda") -> float:
    """Train one member of the family; returns the final evaluation
    episode-return mean. Runs on CUDA unless the caller asks for another
    device."""
    holder = {}

    def setup_fn(env, cfg, dev, seed):
        setup, holder["warmup"] = q_learner_setup(env, cfg, dev, seed, loss_fn, head_kwargs)
        return setup

    return run_anakin_experiment(config, setup_fn, device,
                                 warmup_fn=lambda state: holder["warmup"](state))
