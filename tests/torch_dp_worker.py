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
from stoix_tpu_torch.utils.training import ClipAdam, ElementClipAdam


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


def _transition(b: dict) -> Transition:
    return Transition(_observation(b["obs"]), *(torch.from_numpy(b[k])
                                                for k in ("action", "reward", "done")),
                      _observation(b["next_obs"]), {k: torch.from_numpy(v)
                                                    for k, v in b["info"].items()})


def sac_step(mesh_for, overrides, actor, q_online, q_target, log_alpha, batches, noises):
    """This rank's ff_sac `update_from_batch` on its own batch
    (`batches[rank]`), once a step of `noises` (the same two normals on
    every rank, as JAX's one trace feeds every shard): params and metrics."""
    from stoix_tpu_torch.systems.ddpg import ff_ddpg
    from stoix_tpu_torch.systems.sac import ff_sac

    rank = dist.get_rank()
    cfg = _config("ff_sac", overrides)
    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    actor_net, q_net, _ = ff_sac.build_networks(env, cfg, torch.Generator())
    optims = ff_sac.make_optimizers(cfg)
    update = ff_sac.SACUpdate(ff_ddpg.make_apply(actor_net), ff_ddpg.make_apply(q_net), optims,
                              cfg)
    actor_p, q_p = _tensors(actor), _tensors(q_online)
    alpha = torch.tensor(float(log_alpha))
    params = [ff_sac.SACParams(actor_p, OnlineAndTarget(q_p, _tensors(q_target)), alpha)]
    opts = [ff_sac.SACOptStates(optims[0].init(actor_p), optims[1].init(q_p),
                                optims[2].init({"log_alpha": alpha}))]
    metrics = []
    for step_noise in noises:
        noise = tuple(torch.from_numpy(x) for x in step_noise)
        params, opts, info = update.step(params, opts, [_transition(batches[rank])], [noise])
        metrics.append({k: float(v) for k, v in info.items()})
    return {"actor": _numpy(params[0].actor_params), "q_online": _numpy(params[0].q_params.online),
            "q_target": _numpy(params[0].q_params.target),
            "log_alpha": float(params[0].log_alpha), "metrics": metrics}


def reinforce_step(mesh_for, overrides, obs_dim, num_actions, actor_params, critic_params,
                   trajs):
    """This rank's ff_reinforce update on its own [T, E] trajectory
    (`trajs[rank]`): params, metrics and its gradient all-reduces."""
    from stoix_tpu_torch.systems.vpg import ff_reinforce

    rank = dist.get_rank()
    cfg = _config("ff_reinforce", overrides)
    actor = base.FeedForwardActor(heads.CategoricalHead(num_actions, 16),
                                  torso.MLPTorso(obs_dim, (16, 16)), inputs.ObservationInput())
    critic = base.FeedForwardCritic(heads.ScalarCriticHead(16), torso.MLPTorso(obs_dim, (16, 16)),
                                    inputs.ObservationInput())
    optims = tuple(ClipAdam(float(cfg.system[k]), float(cfg.system.max_grad_norm), eps=1e-5)
                   for k in ("actor_lr", "critic_lr"))
    learner = ff_reinforce.ReinforceLearner(
        None, (ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic)), optims, cfg)
    params = ActorCriticParams(_tensors(actor_params), _tensors(critic_params))
    opt = ActorCriticOptStates(optims[0].init(params.actor_params),
                               optims[1].init(params.critic_params))
    tr = trajs[rank]
    traj = {"obs": _observation(tr["obs"]), "next_obs": _observation(tr["next_obs"]),
            **{k: torch.from_numpy(tr[k]) for k in ("action", "reward", "discount", "truncated")}}
    counter = anakin.allreduce_counter()
    before = counter.value(labels={"kind": "gradients"})
    params, _, metrics = learner.update(params, opt, traj)
    return {"actor": _numpy(params.actor_params), "critic": _numpy(params.critic_params),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "allreduces": counter.value(labels={"kind": "gradients"}) - before}


def _mpo_batch(d: dict) -> dict:
    return {"obs": _observation(d["obs"]),
            **{k: torch.from_numpy(v) for k, v in d.items() if k not in ("obs", "next_obs")},
            **({"next_obs": _observation(d["next_obs"])} if "next_obs" in d else {})}


def mpo_step(mesh_for, system, overrides, params, batches, epochs):
    """`epochs` epochs of this rank's discrete ff_mpo (`MPOUpdate.step`, on
    `batches[rank]`) or ff_vmpo (`VMPOLearner.epoch`, on the trajectory
    `batches[rank]`) from the given port params: params, duals, metrics
    and the gradient all-reduces."""
    from stoix_tpu_torch.systems.ddpg import ff_ddpg
    from stoix_tpu_torch.systems.mpo import ff_mpo, ff_vmpo

    rank = dist.get_rank()
    cfg = check_total_timesteps(_config(system, overrides), dist.get_world_size())
    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    duals = (torch.tensor(params["log_temperature"]), torch.tensor(params["log_alpha"]))
    pair = lambda key: OnlineAndTarget(_tensors(params[key]["online"]),  # noqa: E731
                                       _tensors(params[key]["target"]))
    batch = _mpo_batch(batches[rank])
    if system == "ff_mpo":
        actor, q_network = ff_mpo.build_networks(env, cfg, torch.Generator(), False)
        optims = ff_mpo.make_optimizers(cfg)
        update = ff_mpo.MPOUpdate(ff_ddpg.make_apply(actor), ff_ddpg.make_apply(q_network),
                                  optims, cfg, False)
        state = ff_mpo.MPOParams(pair("actor"), pair("q"), *duals)
        opt = ff_mpo.MPOOptStates(optims[0].init(state.actor_params.online),
                                  optims[1].init(state.q_params.online),
                                  optims[2].init(ff_mpo.dual_params(*duals)))
        step = lambda p, o: update.step(p, o, [batch], [None])  # noqa: E731
    else:
        actor, critic = ff_ppo.build_networks(env, cfg, torch.Generator())
        optims = ff_vmpo.make_optimizers(cfg)
        learner = ff_vmpo.VMPOLearner(env, (ff_ppo.make_apply_fn(actor),
                                            ff_ppo.make_apply_fn(critic)), optims, cfg, False)
        state = ff_vmpo.VMPOParams(pair("actor"), _tensors(params["critic"]), *duals, 0)
        opt = ff_vmpo.VMPOOptStates(optims[0].init(state.actor_params.online),
                                    optims[1].init(state.critic_params),
                                    optims[2].init(ff_vmpo.dual_params(*duals)))
        step = lambda p, o: learner.epoch(p, o, batch)  # noqa: E731
    counter = anakin.allreduce_counter()
    before = counter.value(labels={"kind": "gradients"})
    states, opts, metrics = [state], [opt], []
    for _ in range(epochs):
        states, opts, info = step(states, opts)
        metrics.append({k: float(v) for k, v in info.items()})
    return {"params": _numpy(states[0]._asdict()), "metrics": metrics,
            "allreduces": counter.value(labels={"kind": "gradients"}) - before}


def az_step(mesh_for, overrides, params, trajs, perms):
    """This rank's ff_az on-policy `update` on its own [T, E] searched
    trajectory `trajs[rank]` with its permutations [epochs, T.E], from the
    given port params: params, loss info and gradient all-reduces."""
    from stoix_tpu_torch.systems.search import ff_az

    rank = dist.get_rank()
    cfg = check_total_timesteps(_config("ff_az", overrides), dist.get_world_size())
    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    actor, critic = ff_ppo.build_networks(env, cfg, torch.Generator())
    optims = ff_ppo.make_optimizers(cfg)
    learner = ff_az.AZLearner(None, None, (ff_ppo.make_apply_fn(actor),
                                           ff_ppo.make_apply_fn(critic)), optims, cfg)
    state = ActorCriticParams(_tensors(params["actor"]), _tensors(params["critic"]))
    opt = ActorCriticOptStates(optims[0].init(state.actor_params),
                               optims[1].init(state.critic_params))
    tr = trajs[rank]
    traj = ff_az.ExItTransition(
        **{k: torch.from_numpy(v) for k, v in tr.items() if k not in ("obs", "next_obs", "info")},
        obs=_observation(tr["obs"]), next_obs=_observation(tr["next_obs"]), info={})
    counter = anakin.allreduce_counter()
    before = counter.value(labels={"kind": "gradients"})
    state, _, info = learner.update(state, opt, traj,
                                    permutations=[torch.from_numpy(p) for p in perms[rank]])
    return {"actor": _numpy(state.actor_params), "critic": _numpy(state.critic_params),
            "metrics": _numpy(info),
            "allreduces": counter.value(labels={"kind": "gradients"}) - before}


def mz_epoch(mesh_for, overrides, params, batches, epochs):
    """`epochs` epochs of this rank's ff_mz (`MuZeroUpdate`) on its own
    [B, L] sequences `batches[rank]` from the given port params: params,
    metrics and gradient all-reduces."""
    from stoix_tpu_torch.networks.heads import CategoricalHead
    from stoix_tpu_torch.networks.model_based import ActionOneHot
    from stoix_tpu_torch.systems.search import ff_mz

    rank = dist.get_rank()
    cfg = check_total_timesteps(_config("ff_mz", overrides), dist.get_world_size())
    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    nets = ff_mz.build_networks(env, cfg, torch.Generator(), ActionOneHot(env.num_actions),
                                lambda width: CategoricalHead(env.num_actions, width))
    state = ff_mz.MZParams(*(_tensors(params[f]) for f in ff_mz.MZParams._fields))
    optim = ClipAdam(float(cfg.system.lr), float(cfg.system.max_grad_norm), eps=1e-5)
    update = ff_mz.MuZeroUpdate(nets, optim, cfg)
    states, opts = [state], [ff_mz.MZOptStates(optim.init(ff_mz.flat_params(state)))]
    batch = {k: torch.from_numpy(v) for k, v in batches[rank].items()}
    counter = anakin.allreduce_counter()
    before = counter.value(labels={"kind": "gradients"})
    metrics = []
    for _ in range(epochs):
        states, opts, info = update(states, opts, [batch])
        metrics.append({k: float(v) for k, v in info.items()})
    return {"params": _numpy(states[0]._asdict()), "metrics": metrics,
            "allreduces": counter.value(labels={"kind": "gradients"}) - before}


def spo_epoch(mesh_for, overrides, params, batches, epochs):
    """`epochs` epochs of this rank's discrete ff_spo (`SPOUpdate`) on its
    own [B, L] sequences `batches[rank]` from the given port params: params,
    duals, metrics and the gradient all-reduces."""
    from stoix_tpu_torch.systems.spo import ff_spo

    rank = dist.get_rank()
    cfg = check_total_timesteps(_config("ff_spo", overrides), dist.get_world_size())
    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    actor, critic = ff_ppo.build_networks(env, cfg, torch.Generator())
    optims = ff_spo.make_optimizers(cfg)
    update = ff_spo.SPOUpdate((ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic)),
                              optims, cfg, False)
    pair = lambda key: OnlineAndTarget(_tensors(params[key]["online"]),  # noqa: E731
                                       _tensors(params[key]["target"]))
    duals = (torch.tensor(params["log_temperature"]), torch.tensor(params["log_alpha"]))
    state = ff_spo.SPOParams(pair("actor"), pair("critic"), *duals)
    opt = ff_spo.SPOOptStates(optims[0].init(state.actor_params.online),
                              optims[1].init(state.critic_params.online),
                              optims[2].init(ff_spo.dual_params(*duals)))
    batch = _mpo_batch(batches[rank])
    counter = anakin.allreduce_counter()
    before = counter.value(labels={"kind": "gradients"})
    states, opts, metrics = [state], [opt], []
    for _ in range(epochs):
        states, opts, info = update(states, opts, [batch])
        metrics.append({k: float(v) for k, v in info.items()})
    return {"params": _numpy(states[0]._asdict()), "metrics": metrics,
            "allreduces": counter.value(labels={"kind": "gradients"}) - before}


def disco_step(mesh_for, overrides, params, target_params, batches):
    """One ff_disco103 minibatch step (grounded rule) of this rank on its own
    [T, E_mb] minibatch `batches[rank]` from the given port params and
    meta-state: params, the meta-state, the logs and the gradient all-reduces."""
    from stoix_tpu_torch.networks.disco import DiscoAgentOutput
    from stoix_tpu_torch.systems.disco import ff_disco103
    from stoix_tpu_torch.systems.disco.update_rule import MetaState

    rank = dist.get_rank()
    cfg = check_total_timesteps(_config("ff_disco103", overrides), dist.get_world_size())
    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    rule = ff_disco103.make_rule(cfg, env.num_actions, "cpu")
    network = ff_disco103.build_network(env, cfg, torch.Generator(), rule.num_bins)
    optim = ElementClipAdam(float(cfg.system.lr), float(cfg.system.max_abs_update))
    learner = ff_disco103.DiscoLearner(env, ff_ppo.make_apply_fn(network), optim, rule,
                                       rule.init_params(torch.Generator()), cfg)
    b = batches[rank]
    batch = ff_disco103.DiscoTransition(
        **{k: torch.from_numpy(b[k]) for k in ("done", "truncated", "action", "reward")},
        obs=_observation(b["obs"]), info={},
        agent_out=DiscoAgentOutput(**{k: torch.from_numpy(v) for k, v in b["agent_out"].items()}))
    state = _tensors(params)
    meta = MetaState(_tensors(target_params), torch.tensor(0, dtype=torch.int32))
    counter = anakin.allreduce_counter()
    before = counter.value(labels={"kind": "gradients"})
    new_params, _, metas, logs = learner.update_minibatch([state], [optim.init(state)], [meta],
                                                          [batch])
    return {"params": _numpy(new_params[0]), "target_params": _numpy(metas[0].target_params),
            "num_updates": int(metas[0].num_updates),
            "logs": {k: float(v) for k, v in logs.items()},
            "allreduces": counter.value(labels={"kind": "gradients"}) - before}


def sharded_item_buffer(mesh_for, chunks, uniforms, capacity, batch, min_fill, item):
    """The Anakin facade over the sharded replay (replay/compat.py) with this
    rank as one shard of the world: this rank's chunks added, can_sample
    before and after, and one draw whose uniforms this rank's generator
    would give as `uniforms[rank]` (the facade must use rank 0's)."""
    from stoix_tpu_torch.replay import compat

    rank = dist.get_rank()
    buf = compat.make_sharded_item_buffer(capacity, batch, dist.get_world_size(), min_fill,
                                          group=dist.group.WORLD)
    state = buf.init({k: torch.from_numpy(np.array(v)) for k, v in item.items()})
    before = buf.can_sample(state)
    for c in chunks[rank]:
        state = buf.add(state, {k: torch.from_numpy(np.array(v)) for k, v in c.items()})
    drawn = torch.from_numpy(np.array(uniforms[rank]))
    real_rand = torch.rand
    torch.rand = lambda *args, **kwargs: drawn.clone()
    try:
        sample = buf.sample(state, torch.Generator().manual_seed(rank))
    finally:
        torch.rand = real_rand
    return {"experience": _numpy(sample.experience), "can_sample_before": before,
            "can_sample": buf.can_sample(state)}


DP_KINDS = {"mesh_helpers": mesh_helpers, "sharded_item_buffer": sharded_item_buffer,
            "ppo_step": ppo_step, "statistics": statistics,
            "dqn_step": dqn_step, "sequence_step": sequence_step,
            "sequence_buffer": sequence_buffer, "run": run, "saved_state": saved_state,
            "sac_step": sac_step, "reinforce_step": reinforce_step, "mpo_step": mpo_step,
            "az_step": az_step, "mz_epoch": mz_epoch, "spo_epoch": spo_epoch,
            "disco_step": disco_step}
