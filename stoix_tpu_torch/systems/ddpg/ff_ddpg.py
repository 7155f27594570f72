"""Anakin DDPG (counterpart of stoix_tpu/systems/ddpg/ff_ddpg.py), and the
scaffolding the continuous off-policy actor-critics share (ff_td3, ff_d4pg,
ff_sac): a deterministic tanh actor with Gaussian exploration noise, a
Q(s, a) critic (`MultiNetwork` of `num_critics` FeedForwardCritics on
`EmbeddingActionInput`), online and target copies of both, and the item
buffer of systems/off_policy_core.py, pre-filled by `get_random_warmup_fn`
with uniform random actions.

`update_from_batch` on each replica's sampled batch, in the JAX package's
order (ff_ddpg.py:102-133):

  1. the target r + gamma (1 - done) Q_target(s', mu_target(s')), no gradient;
  2. the critic's gradients of mean((Q(s, a) - target)^2), averaged over
     the replicas then the data ranks (`pmean_grads`), a clip + Adam step,
     then the Polyak update of the critic's target;
  3. the actor's gradients of -mean(Q(s, mu(s))) against the UPDATED online
     critic, averaged likewise, a clip + Adam step, the actor's Polyak.

Acting adds normal . sigma . (hi - lo) / 2 to the actor's action, in that
order of operations, and clips to [lo, hi]. The evaluator takes replica 0's
online actor. The JAX ff_ddpg does not read `system.update_guard`; the port
refuses it (ROADMAP C18).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

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
from stoix_tpu_torch.utils.tree import tree_stack


class DDPGParams(NamedTuple):
    actor_params: OnlineAndTarget
    q_params: OnlineAndTarget


class DDPGOptStates(NamedTuple):
    actor_opt_state: Any
    q_opt_state: Any


def refuse_ignored_knobs(config: Any, system_name: str) -> None:
    """Raise NotImplementedError, naming the key, for `system.update_guard`
    set away from off: the JAX system does not read it (ROADMAP C18), and
    the port does not apply it silently either."""
    if guards.resolve_mode(config) != "off":
        raise NotImplementedError(f"not ported for {system_name} (the JAX package's "
                                  f"{system_name} ignores it): system.update_guard")


def action_bounds(env: envs.Environment) -> Tuple[float, float]:
    """(lo, hi): the smallest low and the largest high of the env's Box, as
    host floats (the JAX systems' `float(jnp.min(low))`, `float(jnp.max(high))`)."""
    space = env.action_space()
    return (float(torch.as_tensor(space.low, dtype=torch.float32).min()),
            float(torch.as_tensor(space.high, dtype=torch.float32).max()))


def build_actor(env: envs.Environment, config: Any, generator: torch.Generator,
                **head_kwargs: Any) -> torch.nn.Module:
    """FeedForwardActor from `network.actor_network`; the head takes the
    env's action count and `head_kwargs`."""
    from stoix_tpu_torch.networks.base import FeedForwardActor

    cfg = config.network.actor_network
    input_layer = config_lib.instantiate(cfg.input_layer)
    in_dim = int(input_layer(env.observation_value()).shape[-1])
    torso = config_lib.instantiate(cfg.pre_torso, input_dim=in_dim, generator=generator)
    head = config_lib.instantiate(cfg.action_head, input_dim=torso.output_dim,
                                  generator=generator, action_dim=env.num_actions, **head_kwargs)
    return FeedForwardActor(head, torso, input_layer)


def build_critic(env: envs.Environment, config: Any, generator: torch.Generator,
                 **head_kwargs: Any) -> torch.nn.Module:
    """FeedForwardCritic from `network.critic_network`, its input layer fed
    an observation and an action."""
    from stoix_tpu_torch.networks.base import FeedForwardCritic

    cfg = config.network.critic_network
    input_layer = config_lib.instantiate(cfg.input_layer)
    action = torch.as_tensor(env.action_value(), dtype=torch.float32)
    in_dim = int(input_layer(env.observation_value(), action).shape[-1])
    torso = config_lib.instantiate(cfg.pre_torso, input_dim=in_dim, generator=generator)
    head = config_lib.instantiate(cfg.critic_head, input_dim=torso.output_dim,
                                  generator=generator, **head_kwargs)
    return FeedForwardCritic(head, torso, input_layer)


def build_networks(env: envs.Environment, config: Any, generator: torch.Generator,
                   num_critics: int = 1):
    """(actor, q_network, (lo, hi)): the deterministic actor on [lo, hi] and
    a MultiNetwork of `num_critics` Q(s, a) critics, its outputs [..., num_critics]."""
    from stoix_tpu_torch.networks.base import MultiNetwork

    lo, hi = action_bounds(env)
    actor = build_actor(env, config, generator, minimum=lo, maximum=hi)
    q_network = MultiNetwork([build_critic(env, config, generator) for _ in range(num_critics)])
    return actor, q_network, (lo, hi)


def make_apply(network: torch.nn.Module) -> Callable[..., Any]:
    """`apply(params, *inputs)`: the network with `params` swapped in."""
    return lambda params, *inputs: functional_call(network, params, inputs)


def detached_params(network: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in network.named_parameters()}


def make_optimizers(config: Any) -> Tuple[ClipAdam, ClipAdam]:
    """The actor's and the critic's clip + Adam (eps 1e-5), their rates
    decaying over every epoch of the run under `decay_learning_rates`."""
    epochs = int(config.system.epochs)
    return tuple(ClipAdam(make_learning_rate(float(config.system[key]), config, epochs),
                          float(config.system.max_grad_norm), eps=1e-5)
                 for key in ("actor_lr", "q_lr"))


def join_metrics(per_replica: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """One replica's metrics as they are, several stacked on a leading [U] axis."""
    return dict(per_replica[0]) if len(per_replica) == 1 else tree_stack(list(per_replica))


def discounts(batch: Transition, gamma: float) -> torch.Tensor:
    """gamma . (1 - done), as the JAX systems form d_t."""
    return gamma * (1.0 - batch.done.to(torch.float32))


def exploration_act_fn(actor_apply: Callable, config: Any, bounds: Tuple[float, float]
                       ) -> core.ActFn:
    """The online actor's action plus normal . sigma . (hi - lo) / 2 from the
    replica's generator, clipped to [lo, hi] (ff_ddpg.py:135-138)."""
    sigma = float(config.system.get("exploration_sigma", 0.1))
    lo, hi = bounds

    def act_in_env(params: DDPGParams, observation: Any, generator: torch.Generator,
                   buffer_state: Any = None) -> torch.Tensor:
        action = actor_apply(params.actor_params.online, observation).mode()
        noise = torch.randn(action.shape, generator=generator, device=action.device,
                            dtype=action.dtype) * sigma * (hi - lo) / 2
        return torch.clamp(action + noise, lo, hi)

    return act_in_env


class DDPGUpdate:
    """`update_from_batch` of DDPG over lists of one entry a replica:
    `update(params, opt_states, batches, generators)`, the noise drawn from
    each replica's generator (`draw_noise`; none here) and handed to `step`,
    which a test can call with noise of its own."""

    def __init__(self, actor_apply: Callable, q_apply: Callable,
                 optims: Tuple[ClipAdam, ClipAdam], config: Any, bounds: Tuple[float, float]):
        self.actor_apply, self.q_apply = actor_apply, q_apply
        self.actor_optim, self.q_optim = optims
        self.gamma = float(config.system.gamma)
        self.tau = float(config.system.tau)
        self.bounds = bounds
        self.data_group = anakin.data_group()

    @staticmethod
    def initial_opt_states(opt_states: DDPGOptStates) -> Any:
        """The optimizer states the update carries (TD3 adds its step count)."""
        return opt_states

    # ------------------------------------------------------------ the system's parts

    def draw_noise(self, batch: Transition, generator: Optional[torch.Generator]) -> Any:
        return None

    def targets(self, params: DDPGParams, batch: Transition, noise: Any) -> torch.Tensor:
        next_action = self.actor_apply(params.actor_params.target, batch.next_obs).mode()
        q_next = self.q_apply(params.q_params.target, batch.next_obs, next_action)[..., 0]
        return batch.reward + discounts(batch, self.gamma) * q_next

    def q_loss(self, q_online: Dict[str, torch.Tensor], batch: Transition,
               target: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        q_pred = self.q_apply(q_online, batch.obs, batch.action)  # [B, num_critics]
        loss = torch.mean((q_pred - target[:, None]) ** 2)
        return loss, {"q_loss": loss, "mean_q": torch.mean(q_pred)}

    def actor_loss(self, actor_online: Dict[str, torch.Tensor], q_online: Dict[str, torch.Tensor],
                   obs: Any) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        action = self.actor_apply(actor_online, obs).mode()
        loss = -torch.mean(self.q_apply(q_online, obs, action)[..., 0])
        return loss, {"actor_loss": loss}

    # ------------------------------------------------------------ the update

    def __call__(self, params: List[Any], opt_states: List[Any], batches: List[Transition],
                 generators: Optional[Sequence[torch.Generator]] = None):
        generators = [None] * len(batches) if generators is None else generators
        noises = [self.draw_noise(b, g) for b, g in zip(batches, generators)]
        return self.step(params, opt_states, batches, noises)

    def critic_step(self, params: List[Any], opt_states: List[Any], batches: List[Transition],
                    noises: Sequence[Any]):
        """The critics' update of every replica: (new q OnlineAndTargets, new
        critic optimizer states, the metrics of each replica)."""
        with torch.no_grad():
            targets = [self.targets(p, b, n) for p, b, n in zip(params, batches, noises)]
        per = [core.value_and_grad(self.q_loss, p.q_params.online, b, t)
               for p, b, t in zip(params, batches, targets)]
        grads = core.pmean_grads([g for g, _ in per], self.data_group)
        q_params, q_opts = [], []
        for p, opt in zip(params, opt_states):
            updates, q_opt = self.q_optim.update(grads, opt.q_opt_state)
            online = apply_updates(p.q_params.online, updates)
            q_params.append(OnlineAndTarget(online, incremental_update(online, p.q_params.target,
                                                                       self.tau)))
            q_opts.append(q_opt)
        return q_params, q_opts, [m for _, m in per]

    def actor_step(self, actor_params: List[OnlineAndTarget], actor_opts: List[Any],
                   q_online: List[Dict[str, torch.Tensor]], batches: List[Transition]):
        """The actors' update of every replica against the given online
        critics: (new actor OnlineAndTargets, new optimizer states, metrics)."""
        per = [core.value_and_grad(self.actor_loss, a.online, q, b.obs)
               for a, q, b in zip(actor_params, q_online, batches)]
        grads = core.pmean_grads([g for g, _ in per], self.data_group)
        new_params, new_opts = [], []
        for a, opt in zip(actor_params, actor_opts):
            updates, opt = self.actor_optim.update(grads, opt)
            online = apply_updates(a.online, updates)
            new_params.append(OnlineAndTarget(online, incremental_update(online, a.target,
                                                                         self.tau)))
            new_opts.append(opt)
        return new_params, new_opts, [m for _, m in per]

    def step(self, params: List[DDPGParams], opt_states: List[DDPGOptStates],
             batches: List[Transition], noises: Sequence[Any]):
        q_params, q_opts, q_metrics = self.critic_step(params, opt_states, batches, noises)
        actor_params, actor_opts, actor_metrics = self.actor_step(
            [p.actor_params for p in params], [o.actor_opt_state for o in opt_states],
            [q.online for q in q_params], batches)
        new_params = [DDPGParams(a, q) for a, q in zip(actor_params, q_params)]
        new_opts = [DDPGOptStates(a, q) for a, q in zip(actor_opts, q_opts)]
        return new_params, new_opts, join_metrics(
            [{**q, **a} for q, a in zip(q_metrics, actor_metrics)])


def assemble_setup(env: envs.Environment, config: Any, device: torch.device, env_seed: int,
                   step_seed: int, params: Any, opt_states: Any, update: Any,
                   act_in_env: core.ActFn, eval_apply: Callable,
                   eval_params_fn: Callable[[Any], Any]) -> Tuple[AnakinSetup, Callable]:
    """The item buffers (one a replica), the learner and its initial state,
    with `params` and `opt_states` copied to every replica; returns (setup,
    the uniform warm-up)."""
    update_batch = int(config.arch.get("update_batch_size", 1))
    buffer, buffer_state = core.build_buffer(env, config, device)
    buffer_states = [buffer_state] + [buffer.init(core.dummy_transition(env, False, device))
                                      for _ in range(update_batch - 1)]
    learner = core.OffPolicyLearner(env, buffer, config, update, act_in_env,
                                    update_takes_generators=True)
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    learner_state = OffPolicyLearnerState(
        params=anakin.broadcast_to_update_batch(params, update_batch),
        opt_states=anakin.broadcast_to_update_batch(opt_states, update_batch),
        buffer_state=anakin.join_per_replica(buffer_states),
        generator=anakin.make_step_generators(step_seed, device, update_batch),
        env_state=env_state,
        timestep=timestep,
    )
    setup = AnakinSetup(
        learn=learner,
        learner_state=learner_state,
        eval_act_fn=get_distribution_act_fn(config, eval_apply),
        eval_params_fn=lambda s: eval_params_fn(anakin.split_replicas(s.params, update_batch)[0]),
    )
    return setup, core.get_random_warmup_fn(learner, env, config)


def learner_setup(env: envs.Environment, config: Any, device: torch.device, seed: int,
                  networks: Optional[Callable] = None, update_cls: type = DDPGUpdate,
                  system_name: str = "ff_ddpg") -> Tuple[AnakinSetup, Callable]:
    """The networks (`networks(env, config, generator) -> (actor, q_network,
    bounds)`, one critic by default, initialised on the CPU from `seed`,
    then moved to `device`), clip + Adam for each, the buffers, the learner
    and its initial state; returns (setup, warmup). ff_td3 and ff_d4pg pass
    their networks and update."""
    refuse_ignored_knobs(config, system_name)
    config.system.action_dim = env.num_actions
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)
    actor, q_network, bounds = (networks or build_networks)(
        env, config, anakin.make_generator(init_seed, torch.device("cpu")))
    actor.to(device)
    q_network.to(device)
    actor_apply, q_apply = make_apply(actor), make_apply(q_network)
    optims = make_optimizers(config)
    actor_p, q_p = detached_params(actor), detached_params(q_network)
    params = DDPGParams(OnlineAndTarget(actor_p, actor_p), OnlineAndTarget(q_p, q_p))
    opt_states = update_cls.initial_opt_states(
        DDPGOptStates(optims[0].init(actor_p), optims[1].init(q_p)))
    update = update_cls(actor_apply, q_apply, optims, config, bounds)
    return assemble_setup(env, config, device, env_seed, step_seed, params, opt_states, update,
                          exploration_act_fn(actor_apply, config, bounds), actor_apply,
                          lambda p: p.actor_params.online)


def run_off_policy_experiment(config: Any, setup_fn: Callable,
                              device: Union[str, torch.device] = "cuda") -> float:
    """Train one of the continuous off-policy actor-critics: `setup_fn(env,
    config, device, seed) -> (setup, warmup)`; returns the final evaluation
    episode-return mean. Runs on CUDA unless the caller asks for another
    device."""
    holder = {}

    def wrapped(env, cfg, dev, seed):
        setup, holder["warmup"] = setup_fn(env, cfg, dev, seed)
        return setup

    return run_anakin_experiment(config, wrapped, device,
                                 warmup_fn=lambda state: holder["warmup"](state))


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    return run_off_policy_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_ddpg.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
