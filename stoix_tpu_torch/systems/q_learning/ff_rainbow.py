"""Anakin Rainbow (counterpart of stoix_tpu/systems/q_learning/ff_rainbow.py):
prioritised replay of (n + 1)-step sequences, the noisy dueling C51 network
(networks/dueling.py::NoisyDistributionalDuelingQNetwork) with its noise
drawn from the replica's generator, C51 projection targets over n-step
returns, and an importance-weighted loss whose per-sequence cross-entropies
become the sequences' new priorities.

On the learner of systems/off_policy_core.py:

  - acting: one noise draw a step for the online network, then a sample of
    its epsilon-greedy distribution (`system.evaluation_epsilon`, 0);
  - each step stores obs, action, reward, discount and next_obs, added as
    [E_u, T] trajectories to the replica's prioritised trajectory buffer
    (`period` 1, sequences of `n_step` + 1, `max_length_time_axis` from
    `trajectory_buffer_sizing` with at least 2 x `rollout_length` slots);
  - the warmup fills it from uniform random actions, in the same layout;
  - each epoch samples one PrioritisedSample a replica, runs the loss with
    three independent noise draws (the online network at s_0 and at s_n,
    the target network at s_n), averages the gradients (replicas, then data
    ranks: `pmean_grads`), takes the clip + Adam and Polyak steps, and writes
    each replica's cross-entropies back as its priorities.

The importance weights are normalised by the maximum of the replica's own
batch, as in the JAX package, whose loss runs per shard and replica. The
evaluator acts on the noise-free network (the means only). The JAX
ff_rainbow does not read `system.update_guard`; the port refuses it.
"""

from __future__ import annotations

from typing import Any, Union

import torch
import torch.nn.functional as F
from torch.func import functional_call

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import OffPolicyLearnerState, OnlineAndTarget
from stoix_tpu_torch.buffers import make_prioritised_trajectory_buffer
from stoix_tpu_torch.evaluator import get_distribution_act_fn
from stoix_tpu_torch.networks.layers import draw_noise
from stoix_tpu_torch.ops.losses import categorical_l2_project
from stoix_tpu_torch.systems import anakin, off_policy_core as core
from stoix_tpu_torch.systems.q_learning import ff_c51, q_family
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam, make_learning_rate
from stoix_tpu_torch.utils.tree import tree_map


def n_step_return(reward: torch.Tensor, discount: torch.Tensor, gamma: float):
    """(r_n, d_n) of [B, n + 1] sequences: the discounted sum of the first n
    rewards and the product of their discounts, by cumprod and sum as the
    JAX package forms them (the bootstrap state is the last element's obs)."""
    discounts = gamma * discount[:, :-1]  # [B, n]
    cum = torch.cumprod(torch.cat([torch.ones_like(discounts[:, :1]), discounts[:, :-1]], dim=1),
                        dim=1)
    return torch.sum(cum * reward[:, :-1], dim=1), torch.prod(discounts, dim=1)


def rainbow_loss(online_params: Any, target_params: Any, sample: Any, q_apply, config: Any,
                 generator: torch.Generator):
    """The importance-weighted C51 loss of one replica's sample, with the
    per-sequence cross-entropies as its new priorities."""
    gamma = float(config.system.gamma)
    beta = float(config.system.get("importance_sampling_exponent", 0.6))
    seq = sample.experience
    obs_0 = tree_map(lambda x: x[:, 0], seq["obs"])
    obs_n = tree_map(lambda x: x[:, -1], seq["obs"])
    action_0 = seq["action"][:, 0].long()
    r_n, d_n = n_step_return(seq["reward"], seq["discount"], gamma)

    noise_0, noise_sel, noise_target = (q_apply.draw_noise(generator) for _ in range(3))
    _, logits_0, atoms = q_apply(online_params, obs_0, noise_0)
    dist_sel, _, _ = q_apply(online_params, obs_n, noise_sel)
    _, logits_n, _ = q_apply(target_params, obs_n, noise_target)
    best_a = torch.argmax(dist_sel.preferences, dim=-1)

    rows = torch.arange(best_a.shape[0], device=best_a.device)
    probs_best = torch.softmax(logits_n, dim=-1)[rows, best_a]
    target_z = r_n[:, None] + d_n[:, None] * atoms[None, :]
    target = categorical_l2_project(target_z, probs_best, atoms).detach()
    logits_a = logits_0[rows, action_0]
    ce = -torch.sum(target * F.log_softmax(logits_a, dim=-1), dim=-1)  # [B]

    weights = (1.0 / torch.clamp_min(sample.probabilities, 1e-9)) ** beta
    weights = weights / torch.max(weights)
    loss = torch.mean(weights * ce)
    return loss, {"q_loss": loss, "priorities": ce}


class NoisyQApply:
    """`apply(params, observation, noise)`: the Q-network with `params` and
    the head's noise (None: the means only); `draw_noise(generator)` draws
    one noise for every noisy layer."""

    def __init__(self, network: torch.nn.Module):
        self.network = network

    def __call__(self, params: Any, observation: Any, noise: Any = None):
        return functional_call(self.network, params, (observation,), {"noise": noise})

    def draw_noise(self, generator: torch.Generator):
        return draw_noise(self.network, generator)


def store_step(last_timestep: Any, action: torch.Tensor, timestep: Any) -> dict:
    """What the buffer keeps of one step (and its episode info, not stored)."""
    return {
        "obs": last_timestep.observation,
        "action": action,
        "reward": timestep.reward,
        "discount": timestep.discount,
        "next_obs": timestep.extras["next_obs"],
        "info": timestep.extras["episode_metrics"],
    }


def dummy_item(env: envs.Environment, device: Any) -> dict:
    obs = tree_map(lambda x: x.to(device), env.observation_value())
    return {
        "obs": obs,
        "action": torch.zeros((), dtype=torch.int32, device=device),
        "reward": torch.zeros((), dtype=torch.float32, device=device),
        "discount": torch.zeros((), dtype=torch.float32, device=device),
        "next_obs": tree_map(lambda x: x.clone(), obs),
    }


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int):
    """The network (initialised on the CPU from `seed`, then moved to
    `device`), clip + Adam, one prioritised trajectory buffer a replica, the
    learner and its initial state; returns (setup, warmup)."""
    q_family.refuse_ignored_knobs(config, "ff_rainbow")
    config.system.action_dim = env.num_actions
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)
    update_batch = int(config.arch.get("update_batch_size", 1))

    q_network = q_family.build_q_network(
        env, config, anakin.make_generator(init_seed, torch.device("cpu")),
        **ff_c51.head_kwargs(config))
    q_network.to(device)
    q_apply = NoisyQApply(q_network)
    optim = ClipAdam(make_learning_rate(float(config.system.q_lr), config,
                                        int(config.system.epochs)),
                     float(config.system.max_grad_norm), eps=1e-5)
    online = {k: v.detach() for k, v in q_network.named_parameters()}

    local_envs, sample_batch, max_length = core.trajectory_buffer_sizing(
        config, 2 * int(config.system.rollout_length))
    buffer = make_prioritised_trajectory_buffer(
        add_batch_size=local_envs,
        sample_batch_size=sample_batch,
        sample_sequence_length=int(config.system.get("n_step", 3)) + 1,
        period=1,
        max_length_time_axis=max_length,
        priority_exponent=float(config.system.get("priority_exponent", 0.6)),
    )

    def act_in_env(params: OnlineAndTarget, observation: Any, generator: torch.Generator,
                   buffer_state: Any = None) -> torch.Tensor:
        dist, _, _ = q_apply(params.online, observation, q_apply.draw_noise(generator))
        return dist.sample(generator)

    learner = core.OffPolicyLearner(
        env, buffer, config,
        q_family.PrioritisedQUpdate(rainbow_loss, q_apply, optim, config), act_in_env,
        store=store_step)
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    learner_state = OffPolicyLearnerState(
        params=anakin.broadcast_to_update_batch(OnlineAndTarget(online, online), update_batch),
        opt_states=anakin.broadcast_to_update_batch(optim.init(online), update_batch),
        buffer_state=anakin.join_per_replica(
            [buffer.init(dummy_item(env, device)) for _ in range(update_batch)]),
        generator=anakin.make_step_generators(step_seed, device, update_batch),
        env_state=env_state,
        timestep=timestep,
    )

    def eval_apply(params: Any, observation: Any):
        return q_apply(params, observation)[0]

    setup = AnakinSetup(
        learn=learner,
        learner_state=learner_state,
        eval_act_fn=get_distribution_act_fn(config, eval_apply),
        eval_params_fn=lambda s: anakin.split_replicas(s.params, update_batch)[0].online,
    )
    return setup, q_family.get_discrete_warmup_fn(learner, config)


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin Rainbow; returns the final evaluation episode-return mean.
    Runs on CUDA unless the caller asks for another device."""
    holder = {}

    def setup_fn(env, cfg, dev, seed):
        setup, holder["warmup"] = learner_setup(env, cfg, dev, seed)
        return setup

    return run_anakin_experiment(config, setup_fn, device,
                                 warmup_fn=lambda state: holder["warmup"](state))


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_rainbow.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
