"""Gossip-group and tensor-parallel jobs for the gloo ranks of
tests/torch_ring_worker.py (tests/test_torch_gossip.py, tests/test_torch_tp.py).
Each job runs on every rank and returns numpy results; the tests hold them
against the JAX package. Like the worker, this module imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams, PPOTransition
from stoix_tpu_torch.networks import base, heads, inputs, torso
from stoix_tpu_torch.observability import get_registry
from stoix_tpu_torch.parallel import gossip, tp
from stoix_tpu_torch.resilience import faultinject
from stoix_tpu_torch.systems import anakin, runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam
from torch_dp_worker import _numpy, _observation, _tensors


class RecordedReduces:
    """Every `torch.distributed.all_reduce` of the block: the global ranks of
    the group it reduced over."""

    def __enter__(self):
        self.ranks = []
        self._all_reduce = dist.all_reduce

        def recording(tensor, *args, group=None, **kwargs):
            members = dist.get_process_group_ranks(group or dist.group.WORLD)
            self.ranks.append(tuple(sorted(members)))
            return self._all_reduce(tensor, *args, group=group, **kwargs)

        dist.all_reduce = recording
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self._all_reduce


def _config(root: str, overrides) -> config_lib.Config:
    return config_lib.compose(config_lib.default_config_dir(), root, list(overrides))


def gossip_update(mesh_for, axes, overrides, obs_dim, num_actions, hidden, actor_params,
                  critic_params, trajs, perms):
    """This rank's ff_ppo `update` on its own trajectory (`trajs[rank]`) with
    its permutations (`perms[rank]`, [epochs, 1, T.E]) on a ("group", "data")
    mesh, then one gossip round (round 0) of its group's params and
    optimizer states: the losses, the states before and after the round,
    and the ranks of every all-reduce of the update."""
    rank = dist.get_rank()
    mesh = mesh_for(axes)
    cfg = _config("default/gossip/default_ff_ppo.yaml", overrides)
    actor = base.FeedForwardActor(heads.CategoricalHead(num_actions, hidden[-1]),
                                  torso.MLPTorso(obs_dim, hidden), inputs.ObservationInput())
    critic = base.FeedForwardCritic(heads.ScalarCriticHead(hidden[-1]),
                                    torso.MLPTorso(obs_dim, hidden), inputs.ObservationInput())
    optims = tuple(ClipAdam(float(cfg.system.actor_lr), float(cfg.system.max_grad_norm),
                            eps=1e-5) for _ in range(2))
    traj = trajs[rank]
    transition = PPOTransition(
        done=torch.from_numpy(traj["done"]), truncated=torch.from_numpy(traj["truncated"]),
        action=torch.from_numpy(traj["action"]), value=torch.from_numpy(traj["value"]),
        reward=torch.from_numpy(traj["reward"]), log_prob=torch.from_numpy(traj["log_prob"]),
        obs=_observation(traj["obs"]), next_obs=_observation(traj["next_obs"]), info={})
    params = ActorCriticParams(_tensors(actor_params), _tensors(critic_params))
    opt_states = ActorCriticOptStates(optims[0].init(params.actor_params),
                                      optims[1].init(params.critic_params))
    with anakin.use_mesh(mesh):
        learner = ff_ppo.get_learner_fn(
            None, (ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic)), optims, cfg)
        with RecordedReduces() as reduces:
            result = learner.update(params, opt_states, transition,
                                    permutations=[torch.from_numpy(p[0]) for p in perms[rank]])
        plan = gossip.build_gossip_plan(cfg, mesh)
        state = ff_ppo.PPOLearnerState(result.params, result.opt_states, None, None, None,
                                       None, None)
        mixed = plan.step(state, 0)
        group_and_size = anakin.group_rank_and_size()
    return {"losses": _numpy(result.loss_info), "params": _numpy(result.params),
            "opt": _numpy(result.opt_states), "mixed_params": _numpy(mixed.params),
            "mixed_opt": _numpy(mixed.opt_states), "reduce_ranks": reduces.ranks,
            "group": group_and_size, "data_group_ranks": tuple(sorted(
                dist.get_process_group_ranks(mesh.get_group("data"))))}


def gossip_run(mesh_for, root, overrides, cwd):
    """One ff_ppo `run_experiment` from `root` on every rank, recording each
    window's params after the learn step and, when a round ran, after the
    round: with the runner's stats and the ranks of every all-reduce."""
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    learn_traj, gossip_traj = [], []
    setup_fn = ff_ppo.learner_setup

    def recording_setup(*args, **kwargs):
        setup = setup_fn(*args, **kwargs)
        learn = setup.learn

        def recorded_learn(state):
            out = learn(state)
            learn_traj.append(_numpy(out.learner_state.params))
            return out

        plan = setup.gossip
        if plan is not None and plan.step is not None:
            step = plan.step

            def recorded_step(state, round_idx):
                mixed = step(state, round_idx)
                gossip_traj.append(_numpy(mixed.params))
                return mixed

            plan = plan._replace(step=recorded_step)
        return setup._replace(learn=recorded_learn, gossip=plan)

    rounds = get_registry().counter(runner.GOSSIP_ROUNDS)
    faults = get_registry().counter(faultinject.FAULTS_INJECTED)
    before, faults_before = rounds.value(), faults.total()
    ff_ppo.learner_setup = recording_setup
    try:
        with RecordedReduces() as reduces:
            final_return = ff_ppo.run_experiment(_config(root, overrides), device="cpu")
    finally:
        ff_ppo.learner_setup = setup_fn
    stats = runner.LAST_RUN_STATS
    return {"return": final_return, "learn": learn_traj, "gossip": gossip_traj,
            "rounds_counted": rounds.value() - before,
            "faults_injected": faults.total() - faults_before,
            "preempted": stats["resilience"]["preempted"],
            "stall_s": stats["goodput"]["stall_s"],
            "stats_gossip": stats["gossip"], "phases": sorted(stats["phase_breakdown"]),
            "mesh": stats["mesh"], "reduce_ranks": sorted(set(reduces.ranks)),
            "history": stats["history"]}


def tp_block(mesh_for, cases):
    """`column_row_block` on a 2-D ("data", "model") mesh for each case
    (global stacked params, a batch x): this rank's output rows (its "data"
    share of the batch), the data-mean loss of mean(out ** 2), its data-mean
    gradients of the rank's model shard and its gradient of the rank's rows
    of x, with the all-reduces of the forward and the backward."""
    mesh = mesh_for({"data": 2, "model": 2})
    data, model = mesh.get_group("data"), mesh.get_group("model")
    d_rank, d_size = dist.get_rank(data), dist.get_world_size(data)
    m_rank = dist.get_rank(model)
    results = []
    for params, x in cases:
        full = tp.ColumnRowParams(*(torch.from_numpy(np.asarray(p)) for p in params))
        local = tp.ColumnRowParams(*(p.clone().requires_grad_(True)
                                     for p in tp.shard_params(full, m_rank)))
        rows = x.shape[0] // d_size
        x_local = torch.from_numpy(x[d_rank * rows:(d_rank + 1) * rows]).requires_grad_(True)
        with RecordedReduces() as forward:
            out = tp.column_row_block(local, x_local, model)
        loss = torch.mean(out ** 2)
        with RecordedReduces() as backward:
            loss.backward()
        grads = anakin.data_mean(tuple(p.grad for p in local), data, kind="tp")
        results.append({
            "out": out.detach().numpy(),
            "loss": float(anakin.data_mean(loss.detach(), data, kind="tp")),
            "grads": [g.numpy() for g in grads], "x_grad": x_local.grad.numpy() / d_size,
            "model_rank": m_rank, "data_rank": d_rank,
            "forward_reduces": forward.ranks, "backward_reduces": backward.ranks,
        })
    return results


GOSSIP_KINDS = {"gossip_update": gossip_update, "gossip_run": gossip_run, "tp_block": tp_block}
