"""Anakin Transformer-PPO (counterpart of
stoix_tpu/systems/ppo/anakin/ff_trans_ppo.py on its single-device path): PPO
whose actor and critic attend causally over a window of each env's last W
observations and read its final position.

`arch.update_batch_size`, checkpointing, the logger's sinks, the env wrappers
and `env.eval_reset_fn` apply as in ff_ppo. The JAX package's ff_trans_ppo
reads none of `system.normalize_observations`, `update_guard`, `fused_update`
or `adaptive_kl_beta` (it ignores them, ROADMAP C9); the port refuses each,
naming it, rather than apply it through ff_ppo's learner.

Each env carries a window [W, F] (zeros are padding, and are attended to: the
JAX package does not mask them). Acting pushes the observation into the
window; the transition stores that context, so training replays exactly what
acting saw; the window clears where an episode ends, so attention never spans
an auto-reset. One update step, in the JAX package's order:

  1. rollout: `rollout_length` steps, storing the acting windows and the true
     next observations;
  2. ONE batched critic pass over the successor windows (each stored window
     shifted by one with `next_obs` pushed last) for the bootstrap values;
  3. truncation-aware GAE under `system.multistep_impl` (`pallas`: one
     launch of kernel B1's GAE entry point);
  4. `epochs` times: a permutation of the T.E windows, then `num_minibatches`
     clipped-PPO updates, actor and critic grads both taken from the
     pre-update params, each a global-norm clip + Adam step.

Every attention layer runs kernel B2 (kernels/flash_attention.py) on the card:
forward in the rollout, the bootstrap and the evaluator (no lse written under
`no_grad`), forward with lse and the two backward kernels in each minibatch.
Per update, L layers: 2.L.T + L + 2.L.E.M forward launches and 2.L.E.M of
each backward kernel.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple, Union

import torch
from torch import nn

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams
from stoix_tpu_torch.evaluator import get_rnn_evaluator_fn
from stoix_tpu_torch.networks.attention import TransformerTorso
from stoix_tpu_torch.networks.heads import CategoricalHead, ScalarCriticHead
from stoix_tpu_torch.systems import anakin
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import (
    PPOLearner,
    initial_train_state,
    make_apply_fn,
    make_optimizers,
)
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam
from stoix_tpu_torch.utils.tree import tree_stack


# ff_ppo's knobs the JAX package's ff_trans_ppo does not read (ROADMAP C9).
_IGNORED_BY_THE_REFERENCE = (
    ("normalize_observations", "system.normalize_observations"),
    ("update_guard", "system.update_guard"),
    ("fused_update", "system.fused_update"),
    ("adaptive_kl_beta", "system.adaptive_kl_beta"),
)


def check_ported_system(config: Any) -> None:
    """Raise NotImplementedError, naming each key, for an ff_ppo knob that
    the JAX package's ff_trans_ppo ignores: the port does not apply it
    silently either."""
    system = config.system
    refused = [name for key, name in _IGNORED_BY_THE_REFERENCE
               if system.get(key, False) not in (False, None, "off")]
    if refused:
        raise NotImplementedError(
            "not ported for ff_trans_ppo (the JAX package's ff_trans_ppo ignores it): "
            + ", ".join(refused))


class TransPPOLearnerState(NamedTuple):
    params: ActorCriticParams  # every tensor [U, ...] when arch.update_batch_size U > 1
    opt_states: ActorCriticOptStates
    generator: Any  # actions and shuffles: a torch.Generator, or a tuple of one a replica
    env_state: Any
    timestep: envs.TimeStep
    window: torch.Tensor  # [E, W, F] past-observation context (zeros = padding)


class TransPPOTransition(NamedTuple):
    done: torch.Tensor
    truncated: torch.Tensor
    action: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    log_prob: torch.Tensor
    window: torch.Tensor  # [E, W, F] context the policy saw
    next_obs: torch.Tensor  # [E, F] true successor observation (bootstrap)
    info: Dict[str, Any]


def push(window: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Slide the window one step: drop the oldest frame, append `obs` last."""
    return torch.cat([window[:, 1:], obs[:, None]], dim=1)


def flat_view(observation: Any) -> torch.Tensor:
    """An observation's agent view as [E, F] (pixels flattened)."""
    view = observation.agent_view
    return view.reshape(view.shape[0], -1)


class WindowActor(nn.Module):
    """Transformer torso over a window [..., W, F], its last position, a
    categorical head."""

    def __init__(self, torso: TransformerTorso, action_head: CategoricalHead):
        super().__init__()
        self.torso = torso
        self.action_head = action_head

    def forward(self, ctx: torch.Tensor) -> Any:
        x = self.torso(ctx.reshape((-1,) + ctx.shape[-2:]))[:, -1]
        return self.action_head(x.reshape(ctx.shape[:-2] + x.shape[-1:]))


class WindowCritic(nn.Module):
    """Transformer torso over a window [..., W, F], its last position, a
    scalar value head."""

    def __init__(self, torso: TransformerTorso, critic_head: ScalarCriticHead):
        super().__init__()
        self.torso = torso
        self.critic_head = critic_head

    def forward(self, ctx: torch.Tensor) -> torch.Tensor:
        x = self.torso(ctx.reshape((-1,) + ctx.shape[-2:]))[:, -1]
        return self.critic_head(x.reshape(ctx.shape[:-2] + x.shape[-1:]))


class TransPPOLearner(PPOLearner):
    """ff_ppo's learner over windows: its own rollout, which carries and
    clears each env's window; the actor and critic read the stored windows,
    and the bootstrap reads the successor windows. `update`, `update_step`
    and the learner call are ff_ppo's."""

    def __init__(
        self,
        env: envs.Environment,
        apply_fns: Tuple[Callable, Callable],
        update_fns: Tuple[ClipAdam, ClipAdam],
        config: Any,
    ):
        check_ported_system(config)
        super().__init__(env, apply_fns, update_fns, config)
        self.reward_scale = 1.0  # the JAX ff_trans_ppo reads no system.reward_scale

    @torch.no_grad()
    def rollout(
        self, state: TransPPOLearnerState
    ) -> Tuple[TransPPOLearnerState, TransPPOTransition]:
        """`rollout_length` env steps; the transitions stacked to [T, E, ...]."""
        params, generators = self.replicas(state.params), self.generators(state.generator)
        env_state, timestep, window = state.env_state, state.timestep, state.window
        transitions = []
        for _ in range(self.rollout_length):
            ctx = push(window, flat_view(timestep.observation))
            action, value, log_prob = self.act(params, generators, ctx)
            env_state, timestep = self.env.step(env_state, action)
            last = timestep.last()
            # Episode boundary: clear the context so attention never spans an auto-reset.
            window = torch.where(last[:, None, None], 0.0, ctx)
            transitions.append(
                TransPPOTransition(
                    done=timestep.discount == 0.0,
                    truncated=last & (timestep.discount != 0.0),
                    action=action,
                    value=value,
                    reward=timestep.reward,
                    log_prob=log_prob,
                    window=ctx,
                    next_obs=flat_view(timestep.extras["next_obs"]),
                    info=timestep.extras["episode_metrics"],
                )
            )
        state = state._replace(env_state=env_state, timestep=timestep, window=window)
        return state, tree_stack(transitions)

    def policy_input(self, traj_batch: TransPPOTransition) -> torch.Tensor:
        return traj_batch.window

    def bootstrap_input(self, traj_batch: TransPPOTransition) -> torch.Tensor:
        """The successor contexts, derived in one shot from the stored windows:
        the true next observation pushed onto each acting context."""
        return torch.cat([traj_batch.window[:, :, 1:], traj_batch.next_obs[:, :, None]], dim=2)

    def loss_info(
        self, loss_actor: torch.Tensor, value_loss: torch.Tensor, entropy: torch.Tensor
    ) -> Dict[str, torch.Tensor]:
        return {"actor_loss": loss_actor, "value_loss": value_loss, "entropy": entropy}


def get_learner_fn(
    env: envs.Environment,
    apply_fns: Tuple[Callable, Callable],
    update_fns: Tuple[ClipAdam, ClipAdam],
    config: Any,
) -> TransPPOLearner:
    return TransPPOLearner(env, apply_fns, update_fns, config)


def observation_width(env: envs.Environment) -> int:
    return int(env.observation_value().agent_view.reshape(-1).shape[0])


def build_networks(
    env: envs.Environment, config: Any, generator: torch.Generator
) -> Tuple[WindowActor, WindowCritic]:
    """The window actor and critic from the `system.*` transformer keys (the
    default config's `network` group is composed but, as in the JAX package,
    not read); the weights draw from `generator`."""
    system = config.system
    window = int(system.get("window_length", 16))

    def make_torso() -> TransformerTorso:
        return TransformerTorso(
            observation_width(env),
            num_layers=int(system.get("num_layers", 2)),
            num_heads=int(system.get("num_heads", 4)),
            head_dim=int(system.get("head_dim", 32)),
            ffn_dim=int(system.get("ffn_dim", 256)),
            max_timesteps=window,
            generator=generator,
        )

    actor_torso = make_torso()
    actor = WindowActor(
        actor_torso, CategoricalHead(env.num_actions, actor_torso.output_dim, generator)
    )
    critic_torso = make_torso()
    critic = WindowCritic(critic_torso, ScalarCriticHead(critic_torso.output_dim, generator))
    return actor, critic


def learner_setup(
    env: envs.Environment, config: Any, device: torch.device, seed: int
) -> AnakinSetup:
    """Build the networks (initialised on the CPU from `seed`, then moved to
    `device`), the optimizers, the learner and its initial state."""
    config.system.action_dim = env.num_actions
    window = int(config.system.get("window_length", 16))
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)

    actor_network, critic_network = build_networks(
        env, config, anakin.make_generator(init_seed, torch.device("cpu"))
    )
    actor_network.to(device)
    critic_network.to(device)
    optims = make_optimizers(config)
    actor_apply, critic_apply = make_apply_fn(actor_network), make_apply_fn(critic_network)
    learner = get_learner_fn(env, (actor_apply, critic_apply), optims, config)
    params, opt_states, generator = initial_train_state(
        actor_network, critic_network, optims, config, device, step_seed)

    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device)
    )
    num_envs = timestep.reward.shape[0]
    learner_state = TransPPOLearnerState(
        params=params,
        opt_states=opt_states,
        generator=generator,
        env_state=env_state,
        timestep=timestep,
        window=torch.zeros((num_envs, window, observation_width(env)), device=device),
    )

    greedy = bool(config.arch.get("evaluation_greedy", False))

    def window_act_fn(params, ctx, observation, done, generator):
        # The window plays the recurrent evaluator's hidden state: carried
        # across eval steps, cleared where an episode is done.
        ctx = push(torch.where(done[:, None, None], 0.0, ctx), flat_view(observation))
        dist = actor_apply(params, ctx)
        return ctx, (dist.mode() if greedy else dist.sample(generator))

    return AnakinSetup(
        learn=learner,
        learner_state=learner_state,
        eval_act_fn=window_act_fn,
        eval_params_fn=lambda s: learner.eval_params(s.params),
    )


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin Transformer-PPO; returns the final evaluation
    episode-return mean. Runs on CUDA unless the caller asks for another device."""
    window = int(config.system.get("window_length", 16))

    def evaluator_setup(eval_env, act_fn, cfg):
        feat = observation_width(eval_env)

        def init_window(episodes: int) -> torch.Tensor:
            return torch.zeros((episodes, window, feat), device=torch.device(device))

        evaluator = get_rnn_evaluator_fn(eval_env, act_fn, cfg, init_window)
        absolute = get_rnn_evaluator_fn(
            eval_env, act_fn, cfg, init_window,
            eval_multiplier=int(cfg.arch.get("absolute_metric_multiplier", 10)),
        )
        return evaluator, absolute

    return run_anakin_experiment(
        config, learner_setup, device, evaluator_setup_fn=evaluator_setup
    )


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_trans_ppo.yaml", sys.argv[1:]
    )
    return run_experiment(config)


if __name__ == "__main__":
    main()
