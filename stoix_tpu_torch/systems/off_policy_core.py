"""Anakin off-policy scaffolding (counterpart of
stoix_tpu/systems/off_policy_core.py: `make_transition`, `dummy_transition`,
`build_buffer`, `get_random_warmup_fn`, `trajectory_buffer_sizing`,
`require_first_add_samplable`, `pmean_grads`, and `OffPolicyLearner`, its
`standard_off_policy_learner` and the loop the sequence-replay systems
ff_rainbow and rec_r2d2 write out).

One update step, in the JAX package's order, for every replica:

  1. rollout: `rollout_length` env steps, each action from
     `act_in_env(params, observation, generator, buffer_state)` (the buffer
     state lets a system key its epsilon schedule on `num_added`), each step
     stored as `store(last_timestep, action, timestep)` gives it (a
     `Transition` by default; an `act_in_env` that returns (action, extras)
     has the extras handed to `store` too);
  2. the [T, E] steps added to the replica's buffer: an item buffer takes
     them time-major merged to T.E items; a trajectory buffer takes them as
     [E_u, T] trajectories, without their episode `info`;
  3. `epochs` times: one batch sampled from the replica's buffer, then
     `update_from_batch` on every replica's batch at once (the system
     averages the replicas' gradients, as the JAX package's pmean over
     "batch" does). An update that draws noise (TD3's target smoothing,
     SAC's actions) also gets the replicas' generators, where the JAX
     package passes `update_key`. From a prioritised trajectory buffer the
     update gets the whole `PrioritisedSample`s and the replicas'
     generators, and returns each replica's new priorities, which are
     written back (`set_priorities`) before the next epoch samples.

`arch.update_batch_size` U > 1 runs U replicas as a Python loop (the CUDA
kernels are ctypes launches, which `torch.func.vmap` cannot batch): params
and optimizer states with a leading [U] axis, one generator, one group of
`total_num_envs // U` envs and one buffer a replica.

Over N data-parallel ranks (systems/anakin.py) each rank rolls out, fills
and samples its own buffers from its `total_num_envs // N` envs (the warm-up
too), the buffer and batch sizes divided over N × U as the JAX package
divides them; the system averages the gradients over the ranks, and the
window's train metrics are averaged over them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ExperimentOutput, OffPolicyLearnerState, Transition
from stoix_tpu_torch.buffers import (
    PrioritisedTrajectoryBuffer, TrajectoryBuffer, make_item_buffer,
)
from stoix_tpu_torch.systems import anakin
from stoix_tpu_torch.utils.tree import tree_leaves, tree_map, tree_merge_leading_dims, tree_stack

# update_from_batch(params, opt_states, batches) -> (params, opt_states, metrics):
# lists of one entry a replica; with `update_takes_generators`, also the
# replicas' generators: update_from_batch(params, opt_states, batches,
# generators). From a prioritised trajectory buffer:
# update_from_batch(params, opt_states, samples, generators)
#     -> (params, opt_states, metrics, priorities).
UpdateFn = Callable[..., Tuple]
# act_in_env(params, observation, generator, buffer_state) -> action, or
# (action, extras): a dict of per-env tensors the acting computed (MPO's
# behaviour log-prob) that the step stores beside the action
ActFn = Callable[[Any, Any, torch.Generator, Any], Any]
# store(last_timestep, action, timestep[, extras]) -> what the buffer keeps of one step
StoreFn = Callable[..., Any]


def make_transition(last_timestep: Any, action: torch.Tensor, timestep: Any) -> Transition:
    return Transition(
        obs=last_timestep.observation,
        action=action,
        reward=timestep.reward,
        done=timestep.discount == 0.0,
        next_obs=timestep.extras["next_obs"],
        info=timestep.extras["episode_metrics"],
    )


def dummy_transition(env: envs.Environment, discrete_actions: bool = False,
                     device: Any = "cpu") -> Transition:
    """One unbatched transition of the env's shapes and dtypes, on `device`."""
    obs = tree_map(lambda x: x.to(device), env.observation_value())
    action = torch.as_tensor(env.action_value(),
                             dtype=torch.int32 if discrete_actions else torch.float32)
    return Transition(
        obs=obs,
        action=action.to(device),
        reward=torch.zeros((), dtype=torch.float32, device=device),
        done=torch.zeros((), dtype=torch.bool, device=device),
        next_obs=tree_map(lambda x: x.clone(), obs),
        info={
            "episode_return": torch.zeros((), dtype=torch.float32, device=device),
            "episode_length": torch.zeros((), dtype=torch.int32, device=device),
            "is_terminal_step": torch.zeros((), dtype=torch.bool, device=device),
        },
    )


def build_buffer(env: envs.Environment, config: Any, device: Any,
                 discrete_actions: bool = False) -> Tuple[Any, Any]:
    """The per-replica item buffer and one replica's initial state: the
    global buffer and batch sizes divided over the N data ranks and U
    replicas, as the JAX package divides them over shards and replicas
    (stoix_tpu/systems/off_policy_core.py:67-105). `system.replay.impl`:

      local    (default) each replica samples its own ring uniformly;
      sharded  the facade over the sharded core (replay/compat.py): the
               same interface, each rank one shard of a ring of
               `buffer_size` a replica, a batch of `batch_size x N` drawn
               GLOBALLY (rank 0's uniforms on every rank), each rank taking
               its `batch_size`; sampling waits for
               `max(batch_size x N, replay.min_fill)` items over the ranks.
               `replay.prioritized` is refused, with the JAX message."""
    n_shards = anakin.data_rank_and_size()[1]
    shards = n_shards * int(config.arch.get("update_batch_size", 1))
    buffer_size = max(1, int(config.system.total_buffer_size) // shards)
    batch_size = max(1, int(config.system.total_batch_size) // shards)
    replay_cfg = dict(config.system.get("replay") or {})
    impl = str(replay_cfg.get("impl", "local"))
    if impl == "local":
        buffer = make_item_buffer(max_length=buffer_size, min_length=batch_size,
                                  sample_batch_size=batch_size)
    elif impl == "sharded":
        from stoix_tpu_torch.replay.compat import make_sharded_item_buffer

        if bool(replay_cfg.get("prioritized", False)):
            # The item buffer's interface has no set_priorities seam: the
            # priorities would freeze at the insert value and the draw stay
            # uniform, so the knob is refused rather than silently ignored.
            raise ValueError(
                "system.replay.prioritized=true is not supported on the "
                "Anakin item-buffer path (no set_priorities seam in the "
                "ItemBuffer interface); use the Sebulba off-policy path "
                "(systems/q_learning/sebulba/ff_dqn.py) for distributed "
                "prioritized replay")
        min_fill = replay_cfg.get("min_fill")
        buffer = make_sharded_item_buffer(
            capacity_per_shard=buffer_size, sample_batch_size=batch_size * n_shards,
            num_shards=n_shards,
            min_fill=max(batch_size * n_shards,
                         int(batch_size * n_shards if min_fill in (None, "~") else min_fill)),
            group=anakin.data_group())
    else:
        raise ValueError(f"system.replay.impl must be 'local' or 'sharded', got {impl!r}")
    return buffer, buffer.init(dummy_transition(env, discrete_actions, device))


def get_random_warmup_fn(learner: "OffPolicyLearner", env: envs.Environment, config: Any
                         ) -> Callable[[OffPolicyLearnerState], OffPolicyLearnerState]:
    """The learner's rollout for `system.warmup_steps` steps of every env on
    uniform random actions of the env's Box (`low + u (high - low)`, each
    replica's uniforms from its generator), added to its buffer as merged
    [T.E] items (stoix_tpu/systems/off_policy_core.py:115-141)."""
    space = env.action_space()

    def uniform(params: Any, observation: Any, generator: torch.Generator,
                buffer_state: Any) -> torch.Tensor:
        return space.sample(generator, (tree_leaves(observation)[0].shape[0],))

    def warmup(state: OffPolicyLearnerState) -> OffPolicyLearnerState:
        return learner.rollout(state, int(config.system.warmup_steps), uniform)[0]

    return warmup


def pmean_grads(grads: List[Dict[str, torch.Tensor]], group: Any) -> Dict[str, torch.Tensor]:
    """The replicas' gradients averaged, then over the data ranks (the JAX
    package's `pmean_grads`: pmean over "batch", then over "data")."""
    return anakin.data_mean(anakin.mean_gradients(grads), group)


def value_and_grad(loss_fn: Callable[..., Tuple[torch.Tensor, Any]],
                   params: Dict[str, torch.Tensor], *args: Any
                   ) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(gradients of `loss_fn(params, *args)`'s loss with respect to
    `params`, its auxiliary output detached): `jax.grad(..., has_aux=True)`."""
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, aux = loss_fn(leaves, *args)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return grads, tree_map(lambda x: x.detach(), aux)


def trajectory_buffer_sizing(config: Any, min_length_time_axis: int) -> Tuple[int, int, int]:
    """(local_envs, sample_batch_size, max_length_time_axis) of a replica's
    sequence buffer: the global env, batch and buffer totals divided over
    the N data ranks x U replicas, as the JAX package divides them over data
    shards x update batch (stoix_tpu/systems/off_policy_core.py:180-204)."""
    denom = anakin.data_rank_and_size()[1] * int(config.arch.get("update_batch_size", 1))
    local_envs = int(config.arch.total_num_envs) // denom
    if local_envs == 0:
        raise ValueError(
            f"arch.total_num_envs ({config.arch.total_num_envs}) must be >= "
            f"num_data_shards * update_batch_size ({denom})")
    sample_batch = max(1, int(config.system.total_batch_size) // denom)
    max_length = max(int(config.system.total_buffer_size) // (denom * local_envs),
                     int(min_length_time_axis))
    return local_envs, sample_batch, max_length


def require_first_add_samplable(config: Any) -> None:
    """Refuse a warmup-less sequence-replay config whose first rollout add
    holds no full sequence: the trajectory buffer would silently serve
    zero-filled sequences to every epoch of the first update."""
    seq = int(config.system.get("sample_sequence_length", 8))
    rollout = int(config.system.rollout_length)
    if rollout - seq + 1 <= 0:
        raise ValueError(
            f"system.sample_sequence_length ({seq}) must be <= "
            f"system.rollout_length ({rollout}) for warmup-less replay "
            "learners: the first buffer add must already contain a full "
            "sequence, or early updates silently train on zero-filled samples")


def episode_info(traj: Any) -> Any:
    """The episode metrics of stored steps: a Transition's `info`, or a
    dict's "info" entry."""
    return traj["info"] if isinstance(traj, dict) else traj.info


class OffPolicyLearner:
    """The standard off-policy learner: `learner(state) -> ExperimentOutput`
    runs `arch.num_updates_per_eval` update steps; `rollout` and `update` are
    the two halves of one step."""

    def __init__(self, env: envs.Environment, buffer: Any, config: Any,
                 update_from_batch: UpdateFn, act_in_env: ActFn,
                 store: StoreFn = make_transition, update_takes_generators: bool = False):
        self.env = env
        self.buffer = buffer
        self.update_from_batch = update_from_batch
        self.update_takes_generators = update_takes_generators
        self.act_in_env = act_in_env
        self.store = store
        self.sequences = isinstance(buffer, (TrajectoryBuffer, PrioritisedTrajectoryBuffer))
        self.prioritised = isinstance(buffer, PrioritisedTrajectoryBuffer)
        self.rollout_length = int(config.system.rollout_length)
        self.epochs = int(config.system.epochs)
        self.num_updates_per_eval = int(config.arch.num_updates_per_eval)
        self.update_batch = int(config.arch.get("update_batch_size", 1))
        self.data_group = anakin.data_group()

    def add(self, buffers: List[Any], traj: Any) -> List[Any]:
        """Each replica's [T, E_u] steps added to its buffer: time-major
        merged items, or [E_u, T] trajectories without their `info`."""
        if self.sequences:
            stored = {k: v for k, v in traj.items() if k != "info"}
            return [self.buffer.add(b, tree_map(lambda x: x.transpose(0, 1), anakin.env_group(
                stored, u, self.update_batch, 1))) for u, b in enumerate(buffers)]
        return [self.buffer.add(b, tree_merge_leading_dims(
            anakin.env_group(traj, u, self.update_batch, 1), 2)) for u, b in enumerate(buffers)]

    @torch.no_grad()
    def rollout(self, state: OffPolicyLearnerState, steps: Optional[int] = None,
                act_in_env: Optional[ActFn] = None) -> Tuple[OffPolicyLearnerState, Transition]:
        """`steps` env steps (`rollout_length` by default), each action from
        `act_in_env` (the learner's by default); the transitions stacked to
        [T, E, ...] and added to the buffers."""
        steps = self.rollout_length if steps is None else steps
        act_in_env = self.act_in_env if act_in_env is None else act_in_env
        params = anakin.split_replicas(state.params, self.update_batch)
        generators = anakin.per_replica(state.generator, self.update_batch)
        buffers = anakin.per_replica(state.buffer_state, self.update_batch)
        env_state, timestep = state.env_state, state.timestep
        transitions = []
        for _ in range(steps):
            observation = timestep.observation
            parts = [act_in_env(p, anakin.env_group(observation, u, self.update_batch, 0),
                                     g, b)
                     for u, (p, g, b) in enumerate(zip(params, generators, buffers))]
            extras = ()
            if isinstance(parts[0], tuple):  # (action, what the acting also stores)
                parts, acted = zip(*parts)
                extras = (tree_map(lambda *xs: xs[0] if len(xs) == 1 else torch.cat(xs),
                                   *acted),)
            action = parts[0] if len(parts) == 1 else torch.cat(parts)
            env_state, next_timestep = self.env.step(env_state, action)
            transitions.append(self.store(timestep, action, next_timestep, *extras))
            timestep = next_timestep
        traj = tree_stack(transitions)
        buffers = self.add(buffers, traj)
        return state._replace(buffer_state=anakin.join_per_replica(buffers), env_state=env_state,
                              timestep=timestep), traj

    def update(self, state: Any) -> Tuple[Any, Dict]:
        """`epochs` times: a batch from each replica's buffer, then one
        update of every replica (and, from a prioritised buffer, the new
        priorities written back)."""
        params = anakin.split_replicas(state.params, self.update_batch)
        opt_states = anakin.split_replicas(state.opt_states, self.update_batch)
        generators = anakin.per_replica(state.generator, self.update_batch)
        buffers = anakin.per_replica(state.buffer_state, self.update_batch)
        per_epoch = []
        for _ in range(self.epochs):
            samples = [self.buffer.sample(b, g) for b, g in zip(buffers, generators)]
            if self.prioritised:
                params, opt_states, metrics, priorities = self.update_from_batch(
                    params, opt_states, samples, generators)
                buffers = [self.buffer.set_priorities(b, s.indices, p)
                           for b, s, p in zip(buffers, samples, priorities)]
            else:
                batches = [s.experience for s in samples]
                extra = (generators,) if self.update_takes_generators else ()
                params, opt_states, metrics = self.update_from_batch(
                    params, opt_states, batches, *extra)
            per_epoch.append(metrics)
        state = state._replace(params=anakin.join_replicas(params),
                               opt_states=anakin.join_replicas(opt_states),
                               buffer_state=anakin.join_per_replica(buffers))
        return state, tree_stack(per_epoch)

    def update_step(self, state: Any) -> Tuple[Any, Tuple]:
        state, traj = self.rollout(state)
        state, loss_info = self.update(state)
        return state, (episode_info(traj), loss_info)

    def __call__(self, state: OffPolicyLearnerState) -> ExperimentOutput:
        episode_info, loss_info = [], []
        for _ in range(self.num_updates_per_eval):
            state, (episodes, losses_) = self.update_step(state)
            episode_info.append(episodes)
            loss_info.append(losses_)
        return ExperimentOutput(state, tree_stack(episode_info), anakin.data_mean(
            tree_stack(loss_info), self.data_group, kind="metrics"))
