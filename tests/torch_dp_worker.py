"""Data-parallel jobs for the gloo ranks of tests/torch_ring_worker.py
(tests/test_torch_data_parallel.py). Each job runs on every rank of one group
and returns numpy results; the test holds them against the JAX package under
`shard_map`. Like the worker, this module imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import (
    ActorCriticOptStates, ActorCriticParams, OnlineAndTarget, PPOTransition, Transition,
)
from stoix_tpu_torch.buffers import PrioritisedSample
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.networks import base, dueling, heads, inputs, torso
from stoix_tpu_torch.ops import running_statistics
from stoix_tpu_torch.parallel import fetch_global, replicate, shard_leading_axis
from stoix_tpu_torch.systems import anakin, off_policy_core, runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.q_learning import ff_dqn, ff_rainbow, q_family, rec_r2d2
from stoix_tpu_torch.utils import checkpointing
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from stoix_tpu_torch.utils.training import ClipAdam


def _config(root: str, overrides) -> config_lib.Config:
    return config_lib.compose(config_lib.default_config_dir(),
                              f"default/anakin/default_{root}.yaml", list(overrides))


def _numpy(tree):
    """A tree of tensors as numpy, dicts and tuples kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree


def _tensors(params: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in params.items()}


def _observation(d: dict) -> Observation:
    return Observation(*(torch.from_numpy(d[k]) for k in Observation._fields))


def ppo_step(mesh_for, overrides, obs_dim, num_actions, hidden, actor_params, critic_params,
             trajs, perms):
    """This rank's ff_ppo `update` on its own [T, U.E] trajectory
    (`trajs[rank]`) with its permutations (`perms[rank]`, [epochs, U, T.E]):
    each replica's local gradients and the data-mean gradients of every
    minibatch, in order, and the params after the step."""
    rank = dist.get_rank()
    cfg = _config("ff_ppo", overrides)
    update_batch = int(cfg.arch.update_batch_size)
    actor = base.FeedForwardActor(heads.CategoricalHead(num_actions, hidden[-1]),
                                  torso.MLPTorso(obs_dim, hidden), inputs.ObservationInput())
    critic = base.FeedForwardCritic(heads.ScalarCriticHead(hidden[-1]),
                                    torso.MLPTorso(obs_dim, hidden), inputs.ObservationInput())
    optims = tuple(ClipAdam(float(cfg.system.actor_lr), float(cfg.system.max_grad_norm),
                            eps=1e-5) for _ in range(2))
    learner = ff_ppo.get_learner_fn(
        None, (ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic)), optims, cfg)
    local, means = [], []
    gradients = learner.gradients

    def recording_gradients(*args):
        out = gradients(*args)
        local.append(_numpy(out[:2]))
        return out

    data_mean = anakin.data_mean

    def recording_mean(tree, group, kind="gradients"):
        out = data_mean(tree, group, kind)
        if kind == "gradients":
            means.append(_numpy(out[:2]))
        return out

    learner.gradients = recording_gradients
    anakin.data_mean = recording_mean
    allreduces = anakin.allreduce_counter().value({"kind": "gradients"})
    try:
        params = ActorCriticParams(_tensors(actor_params), _tensors(critic_params))
        opt_states = ActorCriticOptStates(optims[0].init(params.actor_params),
                                          optims[1].init(params.critic_params))
        traj = trajs[rank]
        transition = PPOTransition(
            done=torch.from_numpy(traj["done"]), truncated=torch.from_numpy(traj["truncated"]),
            action=torch.from_numpy(traj["action"]), value=torch.from_numpy(traj["value"]),
            reward=torch.from_numpy(traj["reward"]), log_prob=torch.from_numpy(traj["log_prob"]),
            obs=_observation(traj["obs"]), next_obs=_observation(traj["next_obs"]), info={})
        given = [torch.from_numpy(p) for p in perms[rank]]
        result = learner.update(
            anakin.broadcast_to_update_batch(params, update_batch),
            anakin.broadcast_to_update_batch(opt_states, update_batch), transition,
            permutations=[p[0] for p in given] if update_batch == 1 else given)
    finally:
        anakin.data_mean = data_mean
    return {"local": local, "means": means, "params": _numpy(result.params),
            "allreduces": anakin.allreduce_counter().value({"kind": "gradients"}) - allreduces}


def statistics(mesh_for, batches):
    """The observation statistics folded twice over this rank's [T, U, E, F]
    batches (`batches[rank]`), the replicas and then the ranks summed."""
    rank = dist.get_rank()
    state = running_statistics.init_state(torch.zeros(batches[rank][0].shape[-1]))
    for batch in batches[rank]:
        state = running_statistics.update(state, torch.from_numpy(batch), replica_axis=1,
                                          group=anakin.data_group(), std_min_value=5e-4,
                                          std_max_value=5e4)
    return _numpy(state._asdict())


def dqn_step(mesh_for, overrides, obs_dim, num_actions, online, target, batches):
    """This rank's ff_dqn `update_from_batch` on its own batch
    (`batches[rank]`), twice, and the buffer the rank builds: its length and
    its sample's size."""
    rank = dist.get_rank()
    cfg = _config("ff_dqn", overrides)
    net = base.FeedForwardActor(heads.DiscreteQNetworkHead(num_actions, 16, epsilon=0.2),
                                torso.MLPTorso(obs_dim, (16, 16)), inputs.ObservationInput())
    optim = ClipAdam(float(cfg.system.q_lr), float(cfg.system.max_grad_norm), eps=1e-5)
    update = q_family.QUpdate(ff_dqn.dqn_loss, q_family.make_q_apply(net), optim, cfg)
    b = batches[rank]
    batch = Transition(_observation(b["obs"]), *(torch.from_numpy(b[k])
                                                 for k in ("action", "reward", "done")),
                       _observation(b["next_obs"]), {k: torch.from_numpy(v)
                                                     for k, v in b["info"].items()})
    params = [OnlineAndTarget(_tensors(online), _tensors(target))]
    opt = [optim.init(params[0].online)]
    losses = []
    for _ in range(2):
        params, opt, info = update(params, opt, [batch])
        losses.append(float(info["q_loss"]))
    env, _ = envs.make(cfg)
    buffer, state = off_policy_core.build_buffer(env, cfg, "cpu", discrete_actions=True)
    generator = torch.Generator().manual_seed(rank)
    sample = buffer.sample(state, generator).experience
    return {"online": _numpy(params[0].online), "target": _numpy(params[0].target),
            "losses": losses, "buffer_length": int(state.experience.reward.shape[0]),
            "sample_size": int(sample.reward.shape[0])}


# The small networks of the sequence-replay parity tests (tests/test_torch_rainbow.py,
# tests/test_torch_r2d2.py), which load the JAX package's flax params into them.
Q_OBS, Q_ACTIONS = 5, 3


def rainbow_network() -> base.FeedForwardActor:
    return base.FeedForwardActor(
        dueling.NoisyDistributionalDuelingQNetwork(Q_ACTIONS, 16, num_atoms=11, vmin=0.0,
                                                   vmax=10.0, layer_sizes=(8,)),
        torso.MLPTorso(Q_OBS, (16,), activation="relu"), inputs.ObservationInput())


def r2d2_network(cell_type: str, hidden: int) -> rec_r2d2.RecurrentQNetwork:
    return rec_r2d2.RecurrentQNetwork(
        heads.DiscreteQNetworkHead(Q_ACTIONS, 8), base.ScannedRNN(8, hidden, cell_type),
        torso.MLPTorso(Q_OBS, (8,)), torso.MLPTorso(hidden, (8,)), inputs.ObservationInput())


def prioritised_sample(raw: dict, probabilities: np.ndarray) -> PrioritisedSample:
    """A PrioritisedSample of numpy sequences (`obs` an Observation's three
    arrays; `hstate` an array or a pair)."""
    def leaf(key, value):
        if key.endswith("obs"):
            return Observation(*(torch.from_numpy(np.ascontiguousarray(v)) for v in value))
        if isinstance(value, tuple):
            return tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in value)
        return torch.from_numpy(np.ascontiguousarray(value))

    experience = {k: leaf(k, v) for k, v in raw.items()}
    batch = int(probabilities.shape[0])
    return PrioritisedSample(experience, torch.zeros((batch, 2), dtype=torch.long),
                             torch.from_numpy(probabilities))


class GivenNoise(ff_rainbow.NoisyQApply):
    """Rainbow's apply with its noise draws replaced by given pairs, in order."""

    def __init__(self, network, pairs):
        super().__init__(network)
        self.pairs = list(pairs)

    def draw_noise(self, generator):
        return self.pairs.pop(0)


def sequence_step(mesh_for, system, overrides, online, target, samples, noise=None,
                  cell_type="gru", hidden=6):
    """This rank's ff_rainbow or rec_r2d2 update epoch on its own
    PrioritisedSample (`samples[epoch][rank]`), once an epoch: the losses,
    the new priorities and the params after the epochs. `noise` is each
    epoch's three noise draws (lists of (e_in, e_out) numpy pairs), the same
    on every rank."""
    rank = dist.get_rank()
    cfg = _config(system, overrides)
    if system == "ff_rainbow":
        net = rainbow_network()
        pairs = [[(torch.from_numpy(a), torch.from_numpy(b)) for a, b in draw]
                 for epoch in noise for draw in epoch]
        q_apply, loss_fn = GivenNoise(net, pairs), ff_rainbow.rainbow_loss
    else:
        net = r2d2_network(cell_type, hidden)
        q_apply, loss_fn = rec_r2d2.make_apply_fn(net), rec_r2d2.r2d2_loss
    optim = ClipAdam(float(cfg.system.q_lr), float(cfg.system.max_grad_norm), eps=1e-5)
    update = q_family.PrioritisedQUpdate(loss_fn, q_apply, optim, cfg)
    params = [OnlineAndTarget(_tensors(online), _tensors(target))]
    opt = [optim.init(params[0].online)]
    losses, priorities = [], []
    for epoch in samples:
        params, opt, info, new = update(params, opt, [prioritised_sample(*epoch[rank])], [None])
        losses.append(float(info["q_loss"]))
        priorities.append(new[0].numpy())
    return {"online": _numpy(params[0].online), "target": _numpy(params[0].target),
            "losses": losses, "priorities": priorities}


def sequence_buffer(mesh_for, system, overrides):
    """The sizes of the prioritised buffer a rank of `system` builds."""
    cfg = check_total_timesteps(_config(system, overrides), dist.get_world_size())
    env, _ = envs.make(cfg)
    module = {"ff_rainbow": ff_rainbow, "rec_r2d2": rec_r2d2}[system]
    setup = module.learner_setup(env, cfg, torch.device("cpu"), seed=1)
    if system == "ff_rainbow":
        setup = setup[0]  # (setup, warmup)
    buffer_state = setup.learner_state.buffer_state
    return {"priorities": tuple(buffer_state.priorities.shape),
            "reward": tuple(buffer_state.experience["reward"].shape),
            "sample_batch": int(setup.learn.buffer.sample(
                buffer_state._replace(num_added=10 ** 6), torch.Generator()
            ).probabilities.shape[0])}


def run(mesh_for, system, overrides, cwd):
    """One `run_experiment` of `system` on every rank, from `cwd` (so
    checkpoints land under it): the return and the runner's stats."""
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    entry = {"ff_ppo": ff_ppo.run_experiment, "ff_dqn": ff_dqn.run_experiment,
             "ff_rainbow": ff_rainbow.run_experiment,
             "rec_r2d2": rec_r2d2.run_experiment}[system]
    final_return = entry(_config(system, overrides), device="cpu")
    stats = runner.LAST_RUN_STATS
    return {"return": final_return, "mesh": stats["mesh"],
            "num_envs_per_rank": stats["num_envs_per_rank"], "history": stats["history"],
            "restored_step": stats["resilience"]["restored_step"]}


def saved_state(mesh_for, store, step):
    """This rank's saved state at `step` under `store`, as the checkpoint
    holds it (generator states as tensors)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    path = os.path.join(store, str(step), checkpointing.state_file(rank, world))
    return {k: (v["generator_state"].numpy() if isinstance(v, dict) else
                v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in torch.load(path, weights_only=True).items()}


def mesh_helpers(mesh_for, x):
    """parallel/mesh.py's helpers on a global array `x`: this rank's shard of
    its leading axis, the shards gathered back (along the leading and the last
    axis), and rank 0's copy of a value that differs by rank."""
    mesh = mesh_for({"data": -1})
    rank = dist.get_rank()
    full = torch.from_numpy(x)
    shard = shard_leading_axis({"x": full}, mesh)["x"]
    return {"shard": shard.numpy(), "gathered": fetch_global({"x": shard}, mesh)["x"],
            "gathered_last": fetch_global(shard.T.contiguous(), mesh, dim=-1),
            "replicated": replicate((full + rank,), mesh)[0].numpy()}


DP_KINDS = {"mesh_helpers": mesh_helpers, "ppo_step": ppo_step, "statistics": statistics,
            "dqn_step": dqn_step, "sequence_step": sequence_step,
            "sequence_buffer": sequence_buffer, "run": run, "saved_state": saved_state}
