"""Anakin R2D2 (counterpart of stoix_tpu/systems/q_learning/rec_r2d2.py, the
JAX package's largest Q system): prioritised SEQUENCE replay with the
recurrent carries stored beside the steps, a burn-in that re-warms both
networks' carries before the trained segment, double Q-learning with a
target network, n-step targets formed on raw values and compared in the
signed hyperbolic space, and an importance-weighted loss whose TD errors
set the sequences' new priorities (eta . max + (1 - eta) . mean of |td|).

The network is pre_torso -> ScannedRNN (`network.rnn_cell_type`, any of
the five cells) -> post_torso -> a Q head over time; it returns the Q
values, which acting wraps in an epsilon-greedy distribution
(`system.training_epsilon` in the rollout, `evaluation_epsilon` in the
evaluator).

On the learner of systems/off_policy_core.py, with its own rollout (the
carries): at each step the network takes one step from its carry, reset
first where the previous step ended an episode (termination or
truncation); the step stores the carry at its START and that reset flag.
The [E_u, T] trajectories go to the replica's prioritised trajectory
buffer (sequences of `burn_in_length + train_length`, on a `period` stride,
at least 2 sequences' worth of slots); each epoch samples one
PrioritisedSample a replica, runs the loss, averages the gradients
(replicas, then data ranks), takes the clip + Adam and Polyak steps and
writes the priorities back. There is no warmup: the first update samples
straight after the first rollout. The JAX rec_r2d2 does not read
`system.update_guard`; the port refuses it.
"""

from __future__ import annotations

from typing import Any, Tuple, Union

import torch
from torch import nn
from torch.func import functional_call

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import OnlineAndTarget, RNNOffPolicyLearnerState
from stoix_tpu_torch.buffers import make_prioritised_trajectory_buffer
from stoix_tpu_torch.networks.base import ScannedRNN
from stoix_tpu_torch.networks.heads import DiscreteQNetworkHead
from stoix_tpu_torch.ops.distributions import EpsilonGreedy
from stoix_tpu_torch.ops.multistep import n_step_bootstrapped_returns
from stoix_tpu_torch.ops.value_transforms import SIGNED_HYPERBOLIC_PAIR
from stoix_tpu_torch.systems import anakin, off_policy_core as core
from stoix_tpu_torch.systems.ppo.anakin.rec_ppo import rnn_width
from stoix_tpu_torch.systems.q_learning import q_family
from stoix_tpu_torch.systems.runner import AnakinSetup, run_rnn_anakin_experiment
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam, make_learning_rate
from stoix_tpu_torch.utils.tree import tree_map, tree_stack


class RecurrentQNetwork(nn.Module):
    """pre_torso -> ScannedRNN -> post_torso -> Q head over time-major
    sequences: (hstate, (observation [T, B, ...], done [T, B])) ->
    (hstate, Q values [T, B, A]). Its modules carry the names of the JAX
    package's RecurrentActor, so that network's flax tree loads as it is."""

    def __init__(self, action_head: DiscreteQNetworkHead, rnn: ScannedRNN,
                 pre_torso: nn.Module, post_torso: nn.Module, input_layer: nn.Module):
        super().__init__()
        self.action_head = action_head
        self.rnn = rnn
        self.pre_torso = pre_torso
        self.post_torso = post_torso
        self.input_layer = input_layer

    def forward(self, hstate: Any, observation_done: Tuple[Any, torch.Tensor]
                ) -> Tuple[Any, torch.Tensor]:
        observation, done = observation_done
        x = self.pre_torso(self.input_layer(observation))
        hstate, x = self.rnn(hstate, (x, done))
        return hstate, self.action_head.dense[0](self.post_torso(x))


def build_network(env: envs.Environment, config: Any,
                  generator: torch.Generator) -> RecurrentQNetwork:
    """The recurrent Q-network from `network.actor_network`'s input layer and
    torsos (its action head is the Q head, as in the JAX package)."""
    net_cfg = config.network.actor_network
    hidden_size, cell_type = rnn_width(config)
    input_layer = config_lib.instantiate(net_cfg.input_layer)
    in_dim = int(input_layer(env.observation_value()).shape[-1])
    pre_torso = config_lib.instantiate(net_cfg.pre_torso, input_dim=in_dim, generator=generator)
    rnn = ScannedRNN(pre_torso.output_dim, hidden_size, cell_type, generator=generator)
    post_torso = config_lib.instantiate(net_cfg.post_torso, input_dim=hidden_size,
                                        generator=generator)
    head = DiscreteQNetworkHead(env.num_actions, post_torso.output_dim,
                                epsilon=float(config.system.evaluation_epsilon),
                                generator=generator)
    return RecurrentQNetwork(head, rnn, pre_torso, post_torso, input_layer)


def make_apply_fn(network: RecurrentQNetwork):
    """`apply(params, hstate, (observation, done))` with `params` swapped in."""
    return lambda params, hstate, inputs: functional_call(network, params, (hstate, inputs))


def r2d2_loss(online_params: Any, target_params: Any, sample: Any, q_apply, config: Any,
              generator: Any = None):
    """One replica's loss on its [B, L] sequences: burn-in, double-Q
    transformed n-step TD errors over the trained segment, importance
    weights normalised by the batch's largest; the new priorities ride in
    the metrics."""
    del generator  # R2D2 draws nothing in its loss
    s = config.system
    gamma, n_step = float(s.gamma), int(s.get("n_step", 5))
    burn_in, eta = int(s.get("burn_in_length", 8)), float(s.get("priority_eta", 0.9))
    beta = float(s.get("importance_sampling_exponent", 0.6))
    tx = SIGNED_HYPERBOLIC_PAIR
    seq = sample.experience
    time_major = lambda x: x.transpose(0, 1)  # noqa: E731
    obs = tree_map(time_major, seq["obs"])
    dones = time_major(seq["done"])
    init_h = tree_map(lambda x: x[:, 0], seq["hstate"])

    with torch.no_grad():  # burn-in: both networks' carries warmed, no gradient
        burn = (tree_map(lambda x: x[:burn_in], obs), dones[:burn_in])
        h_online, _ = q_apply(online_params, init_h, burn)
        h_target, _ = q_apply(target_params, init_h, burn)
    rest = (tree_map(lambda x: x[burn_in:], obs), dones[burn_in:])
    _, q_online = q_apply(online_params, h_online, rest)  # [L', B, A]
    with torch.no_grad():
        _, q_target = q_apply(target_params, h_target, rest)
        action = time_major(seq["action"])[burn_in:].long()
        reward = time_major(seq["reward"])[burn_in:]
        discount = time_major(seq["discount"])[burn_in:]
        # Transformed double n-step targets (the online argmax selects).
        selector = torch.argmax(q_online, dim=-1)
        v_raw = tx.apply_inv(torch.take_along_dim(q_target, selector[..., None], dim=-1)[..., 0])
        targets = n_step_bootstrapped_returns(
            reward[:-1].transpose(0, 1), (gamma * discount[:-1]).transpose(0, 1),
            v_raw[1:].transpose(0, 1), n=n_step).transpose(0, 1)
        targets = tx.apply(targets)

    qa = torch.take_along_dim(q_online, action[..., None], dim=-1)[..., 0][:-1]
    td = targets - qa  # [L' - 1, B]
    abs_td = torch.abs(td.detach())
    priorities = eta * torch.amax(abs_td, dim=0) + (1.0 - eta) * torch.mean(abs_td, dim=0)
    weights = (1.0 / torch.clamp_min(sample.probabilities, 1e-9)) ** beta
    weights = weights / torch.max(weights)
    loss = torch.mean(weights[None, :] * 0.5 * td ** 2)
    return loss, {"q_loss": loss, "mean_q": torch.mean(q_online.detach()),
                  "priorities": priorities}


class R2D2Learner(core.OffPolicyLearner):
    """The off-policy learner with a recurrent rollout: the state carries the
    network's carries and the reset flags across steps and updates."""

    def __init__(self, env: envs.Environment, buffer: Any, config: Any, update_from_batch: Any,
                 q_apply: Any):
        super().__init__(env, buffer, config, update_from_batch, act_in_env=None)
        self.q_apply = q_apply
        self.train_epsilon = float(config.system.training_epsilon)

    @torch.no_grad()
    def rollout(self, state: RNNOffPolicyLearnerState, steps: Any = None, act_in_env: Any = None
                ) -> Tuple[RNNOffPolicyLearnerState, dict]:
        """`rollout_length` env steps; each stored with the carry at its start
        and the reset flag entering it; the steps stacked to [T, E, ...] and
        added to the buffers."""
        params = anakin.split_replicas(state.params, self.update_batch)
        generators = anakin.per_replica(state.generator, self.update_batch)
        buffers = anakin.per_replica(state.buffer_state, self.update_batch)
        env_state, timestep = state.env_state, state.timestep
        done, truncated, hstates = state.done, state.truncated, state.hstates
        group = lambda tree, u: anakin.env_group(tree, u, self.update_batch, 0)  # noqa: E731
        stored = []
        for _ in range(self.rollout_length):
            reset = done | truncated
            observation = timestep.observation
            parts = []
            for u, (p, generator) in enumerate(zip(params, generators)):
                inputs = (tree_map(lambda x: x[None], group(observation, u)), group(reset, u)[None])
                new_h, q = self.q_apply(p.online, group(hstates, u), inputs)
                parts.append((new_h, EpsilonGreedy(q[0], self.train_epsilon).sample(generator)))
            new_hstates = _cat([h for h, _ in parts])
            action = _cat([a for _, a in parts])
            env_state, next_timestep = self.env.step(env_state, action)
            stored.append({
                "obs": observation, "action": action, "reward": next_timestep.reward,
                "discount": next_timestep.discount, "done": reset, "hstate": hstates,
                "info": next_timestep.extras["episode_metrics"],
            })
            done = next_timestep.discount == 0.0
            truncated = next_timestep.last() & (next_timestep.discount != 0.0)
            hstates, timestep = new_hstates, next_timestep
        traj = tree_stack(stored)
        buffers = self.add(buffers, traj)
        return state._replace(buffer_state=anakin.join_per_replica(buffers), env_state=env_state,
                              timestep=timestep, done=done, truncated=truncated,
                              hstates=hstates), traj


def _cat(parts: list) -> Any:
    """The replicas' trees joined along the env axis."""
    return parts[0] if len(parts) == 1 else tree_map(lambda *xs: torch.cat(xs), *parts)


def dummy_item(env: envs.Environment, config: Any, device: Any) -> dict:
    hidden_size, cell_type = rnn_width(config)
    return {
        "obs": tree_map(lambda x: x.to(device), env.observation_value()),
        "action": torch.zeros((), dtype=torch.int32, device=device),
        "reward": torch.zeros((), dtype=torch.float32, device=device),
        "discount": torch.zeros((), dtype=torch.float32, device=device),
        "done": torch.zeros((), dtype=torch.bool, device=device),
        "hstate": ScannedRNN.initialize_carry(cell_type, hidden_size, (), device),
    }


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    """The network (initialised on the CPU from `seed`, then moved to
    `device`), clip + Adam, one prioritised trajectory buffer a replica, the
    learner and its initial state: every env's carry fresh (zeros) and its
    reset flags clear."""
    q_family.refuse_ignored_knobs(config, "rec_r2d2")
    config.system.action_dim = env.num_actions
    hidden_size, cell_type = rnn_width(config)
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)
    update_batch = int(config.arch.get("update_batch_size", 1))

    network = build_network(env, config, anakin.make_generator(init_seed, torch.device("cpu")))
    network.to(device)
    q_apply = make_apply_fn(network)
    optim = ClipAdam(make_learning_rate(float(config.system.q_lr), config,
                                        int(config.system.epochs)),
                     float(config.system.max_grad_norm), eps=1e-5)
    online = {k: v.detach() for k, v in network.named_parameters()}

    seq_len = int(config.system.get("burn_in_length", 8)) + int(
        config.system.get("train_length", 8))
    local_envs, sample_batch, max_length = core.trajectory_buffer_sizing(config, 2 * seq_len)
    buffer = make_prioritised_trajectory_buffer(
        add_batch_size=local_envs,
        sample_batch_size=sample_batch,
        sample_sequence_length=seq_len,
        period=int(config.system.get("period", 4)),
        max_length_time_axis=max_length,
        priority_exponent=float(config.system.get("priority_exponent", 0.6)),
    )
    learner = R2D2Learner(env, buffer, config,
                          q_family.PrioritisedQUpdate(r2d2_loss, q_apply, optim, config), q_apply)
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    num_envs = timestep.reward.shape[0]  # this rank's envs
    learner_state = RNNOffPolicyLearnerState(
        params=anakin.broadcast_to_update_batch(OnlineAndTarget(online, online), update_batch),
        opt_states=anakin.broadcast_to_update_batch(optim.init(online), update_batch),
        buffer_state=anakin.join_per_replica(
            [buffer.init(dummy_item(env, config, device)) for _ in range(update_batch)]),
        generator=anakin.make_step_generators(step_seed, device, update_batch),
        env_state=env_state,
        timestep=timestep,
        done=torch.zeros((num_envs,), dtype=torch.bool, device=device),
        truncated=torch.zeros((num_envs,), dtype=torch.bool, device=device),
        hstates=ScannedRNN.initialize_carry(cell_type, hidden_size, (num_envs,), device),
    )

    greedy = bool(config.arch.get("evaluation_greedy", False))
    eval_epsilon = float(config.system.evaluation_epsilon)

    def rnn_act_fn(params, hstate, observation, done, generator):
        # One step of every eval episode; `done` resets an ended episode's carry.
        hstate, q = q_apply(params, hstate, (tree_map(lambda x: x[None], observation),
                                             done[None]))
        dist = EpsilonGreedy(q[0], eval_epsilon)
        return hstate, dist.mode() if greedy else dist.sample(generator)

    return AnakinSetup(
        learn=learner,
        learner_state=learner_state,
        eval_act_fn=rnn_act_fn,
        eval_params_fn=lambda s: anakin.split_replicas(s.params, update_batch)[0].online,
    )


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin R2D2; returns the final evaluation episode-return mean.
    Runs on CUDA unless the caller asks for another device."""
    return run_rnn_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_rec_r2d2.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
