"""Anakin MuZero (counterpart of stoix_tpu/systems/search/ff_mz.py): search
in a LEARNED model, on the replay learner of ff_az.py.

Networks (MZParams): the RewardBasedWorldModel (an MLP encoder to
`wm_hidden_size`, a stacked RNN of `wm_rnn_layers` `wm_cell_type` cells over
one-hot actions, a 601-atom reward head), the policy on the latent (an MLP
torso and a Categorical head) and the 601-atom value head, all under ONE
clip + Adam.

Acting: the latent of each observation, the policy's logits and the value
decoded by `muzero_pair` form the root; `mcts.muzero_policy` (or the Gumbel
variant) searches through `world_model.step`, the reward and value decoded
by the same codec, the discount gamma. Each step stores obs, action, reward,
done, truncated, the visit weights and the root's search value.

Each epoch, on [B, L] sequences a replica (ff_mz.py:124-216): the value
targets are n-step returns over the STORED search values, cut at
terminations and truncations (plain ops: the windowed fold runs no kernel);
the dynamics unroll L - 1 steps from the first observation's latent, the
latent's gradient scaled by 0.5 at each step; each step's policy
cross-entropy against the visit weights (masked past the episode's end),
the value's and the reward's cross-entropies against the two-hot targets of
`muzero_pair` (the targets times the mask, in the JAX package's order; the
value's loss without the truncation step), entropy; the total's gradients
averaged over the replicas, then the data ranks; one clip + Adam step.

The JAX ff_mz reads neither `system.update_guard` nor
`system.unroll_steps` (its unroll is `sample_sequence_length` - 1); the
port refuses both set (ROADMAP C20).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import torch
from torch.func import functional_call

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import OffPolicyLearnerState
from stoix_tpu_torch.evaluator import get_distribution_act_fn
from stoix_tpu_torch.ops import n_step_bootstrapped_returns
from stoix_tpu_torch.ops.value_transforms import muzero_pair
from stoix_tpu_torch.search import mcts
from stoix_tpu_torch.systems import anakin, off_policy_core as core
from stoix_tpu_torch.systems.ddpg.ff_ddpg import join_metrics
from stoix_tpu_torch.systems.runner import AnakinSetup, run_anakin_experiment
from stoix_tpu_torch.systems.search.ff_az import (
    SearchReplayLearner, _truncated, refuse_ignored_knobs, replay_buffer, scalars,
    search_policy_fn,
)
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import (
    ClipAdam, apply_updates, make_learning_rate, scale_gradient,
)

MZ_IGNORED = ("system.unroll_steps",)


class MZParams(NamedTuple):
    world_model: Dict[str, torch.Tensor]
    policy_head: Dict[str, torch.Tensor]
    value_head: Dict[str, torch.Tensor]


class MZOptStates(NamedTuple):
    opt_state: Any  # ONE ClipAdamState over every parameter, keyed "field/name"


def flat_params(params: NamedTuple) -> Dict[str, torch.Tensor]:
    """One parameter dict of a NamedTuple of dicts, keyed "field/name"."""
    return {f"{field}/{name}": value for field, part in zip(params._fields, params)
            for name, value in part.items()}


def nested_params(flat: Dict[str, torch.Tensor], like: NamedTuple) -> NamedTuple:
    """The inverse of `flat_params`, shaped as `like`."""
    parts: Dict[str, Dict[str, torch.Tensor]] = {field: {} for field in like._fields}
    for key, value in flat.items():
        field, name = key.split("/", 1)
        parts[field][name] = value
    return type(like)(*(parts[field] for field in like._fields))


def module_params(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in module.named_parameters()}


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.softmax_cross_entropy: -sum(labels . log_softmax(logits))."""
    return -torch.sum(labels * torch.log_softmax(logits, dim=-1), dim=-1)


class MuZeroNetworks:
    """The three networks' applies on parameter dicts: `wm(params, method,
    *args)` runs the world model's `initial_state` or `step`."""

    def __init__(self, world_model: torch.nn.Module, policy: torch.nn.Module,
                 value: torch.nn.Module, num_atoms: int, vmin: float, vmax: float):
        self.modules = (world_model, policy, value)
        # One codec serves both the value and the reward head (the same support).
        self.pair = muzero_pair(num_atoms, vmin, vmax)

    def wm(self, params: Dict, method: str, *args: Any) -> Any:
        return functional_call(self.modules[0], params, (method,) + args)

    def policy(self, params: Dict, latent: torch.Tensor) -> Any:
        return functional_call(self.modules[1], params, (latent,))

    def value_logits(self, params: Dict, latent: torch.Tensor) -> torch.Tensor:
        return functional_call(self.modules[2], params, (latent,))

    def latent(self, params: MZParams, view: torch.Tensor) -> torch.Tensor:
        return self.wm(params.world_model, "initial_state", view)

    def value(self, params: MZParams, latent: torch.Tensor) -> torch.Tensor:
        return self.pair.apply_inv(self.value_logits(params.value_head, latent))


class MZActing:
    """ff_mz's acting (ff_mz.py:68-122): the latent search."""

    def __init__(self, nets: MuZeroNetworks, num_actions: int, config: Any):
        self.nets = nets
        self.num_actions = int(num_actions)
        self.gamma = float(config.system.gamma)
        self.num_simulations = int(config.system.get("num_simulations", 25))
        self.max_depth = int(config.system.get("max_depth") or self.num_simulations)
        self.policy_fn, self.dirichlet_fraction = search_policy_fn(config)

    def draw_noise(self, generator: torch.Generator, batch: int) -> mcts.SearchNoise:
        return mcts.draw_noise(generator, batch, self.num_actions, self.dirichlet_fraction,
                               device=generator.device)

    def recurrent_fn(self, params: MZParams, noise: Any, action: torch.Tensor,
                     latent: torch.Tensor) -> Tuple[mcts.RecurrentFnOutput, torch.Tensor]:
        new_latent, reward_logits = self.nets.wm(params.world_model, "step", latent, action)
        reward = self.nets.pair.apply_inv(reward_logits)
        prior = self.nets.policy(params.policy_head, new_latent)
        out = mcts.RecurrentFnOutput(reward=reward, discount=torch.full_like(reward, self.gamma),
                                     prior_logits=prior.logits,
                                     value=self.nets.value(params, new_latent))
        return out, new_latent

    def act(self, params: MZParams, noise: mcts.SearchNoise, sim_state: Any, observation: Any):
        latent = self.nets.latent(params, observation.agent_view)
        prior = self.nets.policy(params.policy_head, latent)
        root = mcts.RootFnOutput(prior_logits=prior.logits,
                                 value=self.nets.value(params, latent), embedding=latent)
        out = self.policy_fn(params, noise, root, self.recurrent_fn, self.num_simulations,
                             max_depth=self.max_depth)
        return out.action, {"search_policy": out.action_weights,
                            "search_value": out.search_value}

    def record(self, params, last_timestep, action, timestep, extras):
        return {
            "obs": last_timestep.observation.agent_view,
            "action": action,
            "reward": timestep.reward,
            "done": (timestep.discount == 0.0).to(torch.float32),
            "truncated": _truncated(timestep),
            "search_policy": extras["search_policy"],
            "search_value": extras["search_value"],
            "info": timestep.extras["episode_metrics"],
        }


class MuZeroUpdate:
    """`update_from_batch` of ff_mz (and ff_sampled_mz) over lists of one
    [B, L] sequence batch a replica: each replica's loss and gradients, the
    gradients averaged, each replica's clip + Adam step."""

    def __init__(self, nets: MuZeroNetworks, optim: ClipAdam, config: Any):
        self.nets, self.optim = nets, optim
        system = config.system
        self.gamma = float(system.gamma)
        self.n_steps = int(system.get("n_steps", 5))
        self.ent_coef = float(system.get("ent_coef", 0.0))
        self.vf_coef = float(system.get("vf_coef", 0.25))
        self.data_group = anakin.data_group()

    def value_rewards(self, seq: Dict, r_t: torch.Tensor, truncated: torch.Tensor
                      ) -> torch.Tensor:
        """The rewards the value targets fold: the environment's."""
        return r_t

    def policy_terms(self, params: MZParams, latent: torch.Tensor, seq: Dict, t: int,
                     mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(policy loss, entropy) at unroll step t: the cross-entropy against
        the visit weights, both masked past the episode's end."""
        prior = self.nets.policy(params.policy_head, latent)
        ce = -torch.sum(seq["search_policy"][:, t] * torch.log_softmax(prior.logits, dim=-1),
                        dim=-1)
        return torch.mean(ce * mask), torch.mean(prior.entropy() * mask)

    def loss(self, flat: Dict[str, torch.Tensor], like: MZParams, seq: Dict
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        params = nested_params(flat, like)
        pair = self.nets.pair
        r_t = seq["reward"][:, :-1]
        done = seq["done"].to(torch.float32)[:, :-1]
        truncated = seq["truncated"].to(torch.float32)[:, :-1]
        # Neither the n-step return nor the unroll crosses an auto-reset: the
        # stored search value after a truncation is the next episode's.
        d_t = self.gamma * (1.0 - done) * (1.0 - truncated)
        value_targets = n_step_bootstrapped_returns(
            self.value_rewards(seq, r_t, truncated), d_t, seq["search_value"][:, 1:],
            self.n_steps)
        latent = self.nets.latent(params, seq["obs"][:, 0])
        mask = torch.ones_like(r_t[:, 0])
        per_step = []
        for t in range(r_t.shape[1]):
            policy_loss, entropy = self.policy_terms(params, latent, seq, t, mask)
            value_logits = self.nets.value_logits(params.value_head, latent)
            value_loss = self.vf_coef * torch.mean(
                softmax_cross_entropy(value_logits, pair.apply(value_targets[:, t] * mask))
                * (1.0 - truncated[:, t] * mask))
            new_latent, reward_logits = self.nets.wm(
                params.world_model, "step", scale_gradient(latent, 0.5), seq["action"][:, t])
            reward_loss = torch.mean(softmax_cross_entropy(
                reward_logits, pair.apply(r_t[:, t] * mask)))
            mask = mask * (1.0 - done[:, t]) * (1.0 - truncated[:, t])
            latent = new_latent
            per_step.append((policy_loss, value_loss, reward_loss, entropy))
        metrics = {name: torch.stack(parts).mean() for name, parts in zip(
            ("policy_loss", "value_loss", "reward_loss", "entropy"), zip(*per_step))}
        total = (metrics["policy_loss"] + metrics["value_loss"] + metrics["reward_loss"]
                 - self.ent_coef * metrics["entropy"])
        return total, metrics

    def __call__(self, params: List[MZParams], opt_states: List[MZOptStates],
                 batches: List[Dict]):
        grads, metrics = [], []
        for p, batch in zip(params, batches):
            g, m = core.value_and_grad(lambda flat: self.loss(flat, p, batch), flat_params(p))
            grads.append(g)
            metrics.append(m)
        grads = anakin.data_mean(anakin.mean_gradients(grads), self.data_group)
        new_params, new_opts = [], []
        for p, opt in zip(params, opt_states):
            updates, opt_state = self.optim.update(grads, opt.opt_state)
            new_params.append(nested_params(apply_updates(flat_params(p), updates), p))
            new_opts.append(MZOptStates(opt_state))
        return new_params, new_opts, join_metrics(metrics)


def build_networks(env: envs.Environment, config: Any, generator: torch.Generator,
                   action_embedder: torch.nn.Module, policy_head: Callable[[int], torch.nn.Module]
                   ) -> MuZeroNetworks:
    """The world model, the latent policy (an MLP of `wm_hidden_size`, then
    `policy_head(width)`) and the value head, their weights drawn from
    `generator` in that order."""
    from stoix_tpu_torch.networks.heads import MLPLogitsHead
    from stoix_tpu_torch.networks.model_based import LatentPolicy, RewardBasedWorldModel
    from stoix_tpu_torch.networks.torso import MLPTorso

    system = config.system
    hidden = int(system.get("wm_hidden_size", 64))
    num_atoms = int(system.get("num_atoms", 601))
    obs_dim = int(env.observation_value().agent_view.shape[-1])
    world_model = RewardBasedWorldModel(
        obs_encoder=MLPTorso(obs_dim, (hidden,), generator=generator),
        reward_head=MLPLogitsHead(num_atoms, hidden, (hidden,), generator=generator),
        action_embedder=action_embedder, hidden_size=hidden,
        num_rnn_layers=int(system.get("wm_rnn_layers", 1)),
        rnn_cell_type=str(system.get("wm_cell_type", "lstm")), generator=generator)
    latent = world_model.latent_dim
    policy = LatentPolicy(MLPTorso(latent, (hidden,), generator=generator), policy_head(hidden))
    value = MLPLogitsHead(num_atoms, latent, (hidden,), generator=generator)
    return MuZeroNetworks(world_model, policy, value, num_atoms,
                          float(system.get("vmin", -300.0)), float(system.get("vmax", 300.0)))


def muzero_setup(env: envs.Environment, config: Any, device: torch.device, seed: int,
                 nets_fn: Callable[[torch.Generator], MuZeroNetworks], acting: Callable,
                 update: Callable, item: Callable[[torch.device], Dict]) -> AnakinSetup:
    """The shared setup of ff_mz and ff_sampled_mz: the networks
    (initialised on the CPU from `seed`, then moved to `device`), one clip
    + Adam over all of them, a trajectory buffer a replica, the learner and
    its initial state."""
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)
    nets = nets_fn(anakin.make_generator(init_seed, torch.device("cpu")))
    for module in nets.modules:
        module.to(device)
    params = MZParams(*(module_params(m) for m in nets.modules))
    optim = ClipAdam(make_learning_rate(float(config.system.lr), config,
                                        int(config.system.epochs)),
                     float(config.system.max_grad_norm), eps=1e-5)
    update_batch = int(config.arch.get("update_batch_size", 1))
    buffer = replay_buffer(config, 6)
    learner = SearchReplayLearner(env, buffer, config, update(nets, optim, config),
                                  acting(nets, env, config))
    env_state, timestep = anakin.reset_envs_for_anakin(
        env, config, anakin.make_generator(anakin.rank_seed(env_seed), device))
    state = OffPolicyLearnerState(
        params=anakin.broadcast_to_update_batch(params, update_batch),
        opt_states=anakin.broadcast_to_update_batch(
            MZOptStates(optim.init(flat_params(params))), update_batch),
        buffer_state=anakin.join_per_replica([buffer.init(item(device))
                                              for _ in range(update_batch)]),
        generator=anakin.make_step_generators(step_seed, device, update_batch),
        env_state=env_state, timestep=timestep)

    def eval_apply(params: MZParams, observation: Any) -> Any:
        return nets.policy(params.policy_head, nets.latent(params, observation.agent_view))

    return AnakinSetup(
        learn=learner, learner_state=state,
        eval_act_fn=get_distribution_act_fn(config, eval_apply),
        eval_params_fn=lambda s: anakin.split_replicas(s.params, update_batch)[0])


def learner_setup(env: envs.Environment, config: Any, device: torch.device,
                  seed: int) -> AnakinSetup:
    from stoix_tpu_torch.networks.heads import CategoricalHead
    from stoix_tpu_torch.networks.model_based import ActionOneHot

    refuse_ignored_knobs(config, "ff_mz", MZ_IGNORED)
    config.system.action_dim = env.num_actions
    num_actions = env.num_actions

    def nets_fn(generator: torch.Generator) -> MuZeroNetworks:
        return build_networks(env, config, generator, ActionOneHot(num_actions),
                              lambda width: CategoricalHead(num_actions, width,
                                                            generator=generator))

    def item(device: torch.device) -> Dict:
        return {"obs": env.observation_value().agent_view.to(device),
                "action": torch.zeros((), dtype=torch.int32, device=device),
                **scalars(device, "reward", "done", "truncated"),
                "search_policy": torch.zeros((num_actions,), device=device),
                **scalars(device, "search_value")}

    return muzero_setup(env, config, device, seed, nets_fn,
                        lambda nets, env_, cfg: MZActing(nets, num_actions, cfg), MuZeroUpdate,
                        item)


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Anakin MuZero; returns the final evaluation episode-return
    mean. Runs on CUDA unless the caller asks for another device."""
    return run_anakin_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_mz.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
