"""Sebulba PPO and IMPACT (counterpart of stoix_tpu/systems/ppo/sebulba/ff_ppo.py),
and the Sebulba runner that Sebulba IMPALA shares.

Actor/learner disaggregation for stateful envs: actor THREADS run inference
on their actor devices and step stateful env batches (the native C++ pool,
or the port's tensor envs on the host, behind envs/factory.py's seam);
trajectories flow through bounded queues (sebulba/core.py's
OnPolicyPipeline) to the learner, which runs the PPO update over its
learner devices; fresh params return through the ParameterServer; the
evaluation runs on its own thread (AsyncEvaluator) on the evaluator device.
The devices come from parallel/roles.py's MeshRoles, which validates the
act/learn/evaluate split as the JAX package does: on a host with one card
every run sets `arch.learner.device_ids=[0]`, and the roles share it.

One learn step, in the JAX package's order, over the learner devices' shards
(each a [T, E/n] slice of the env axis, the actors' payloads concatenated on
it in actor order):

  1. with `system.normalize_observations`, every shard's observations
     normalised with the pre-update statistics, then the raw ones folded in,
     summed over the shards (the JAX package's psum over "data");
  2. a critic pass over each shard's `next_obs` for the bootstrap values;
  3. truncation-aware GAE, in ONE call over the shards side by side where
     they share a device (one launch of B1's GAE entry point under
     `system.multistep_impl: pallas`), each shard's advantages standardised
     over the shard alone, as inside the JAX shard;
  4. `epochs` times: one permutation of a shard's T·E/n samples, drawn from
     the learner's generator and applied to every shard (the JAX key is
     replicated), then `num_minibatches` clipped-PPO updates: each shard's
     actor and critic gradients (two passes; the value loss always clipped),
     SUMMED over the shards in shard order on the first learner device, the
     divergence guard under `system.update_guard`, and a global-norm clip +
     Adam step. The train metrics are the shards' means.

The sum is the JAX package's own arithmetic, whatever its comments say: its
learn steps run under `shard_map` with `check_vma=True`, where the gradient
of the replicated params is summed over "data" by the transpose of their
implicit broadcast, and the `pmean` that follows leaves that sum as it is
(ROADMAP C25). On one learner device sum and mean agree.

The learner steps are functional: every update builds new tensors, so a
version handed to the actors never changes under them (sebulba/core.py).
The rollout's host-side pipelining is the JAX package's: an actor skips the
parameter fetch on its second rollout, so actors run one rollout ahead.
The supervisor (resilience/supervisor.py, `arch.supervision`, on by default)
restarts a crashed actor up to `max_restarts` times, and the AsyncEvaluator
logs a failed evaluation and carries on, as in the JAX package: the counters
`stoix_tpu_sebulba_actor_crashes_total`,
`stoix_tpu_resilience_actor_restarts_total` and
`stoix_tpu_sebulba_evaluator_errors_total` record both.

IMPACT (`system.impact.enabled`, arXiv:1912.00167): actors fetch their
params WITH the version (`get_params_versioned`) and push `(version,
payload)` through an OffPolicyPipeline; `ImpactIngest` hands the learner a
full set of fresh payloads when one is there, else re-steps the newest
buffered batch within `max_staleness` and `max_reuse`, and blocks only when
there is neither. The learn step (`ImpactLearnStep`) is PPO's with a third
input, the target params (refreshed on the host every
`target_update_interval` updates), and `losses.impact_loss` as the actor
loss, the target's log-probs taken with no gradient; GAE runs on every
update, fresh or reused (one B1 GAE launch), and the gradients are summed
over the shards as above. `LAST_RUN_STATS["impact"]` counts the fresh and
reused updates, the staleness and the target refreshes.

Fault injection (resilience/faultinject.py): `arch.fault_spec` or
`STOIX_TPU_FAULT` may arm `actor_crash:N` and `queue_stall:N` (actor 0, at
the top of rollout N); any other fault is refused naming it.

Envs: `env.backend` picks the factory (envs/factory.py::make_factory): the
port's tensor envs on the host, the native pool, or the gymnasium and
envpool adapters. A scenario with no tensor-env twin (a gymnasium or envpool
task id) evaluates on a pool of the factory's through
`get_stateful_evaluator_fn` (`make_evaluator`).

The operations layer, as the JAX runner wires it: `arch.preflight` (the
probe child and the config's cross-checks before any device work),
`arch.integrity` (the determinism probe at each eval boundary: see
`refuse_integrity_without_probe`), the goodput ledger and flight recorder,
telemetry, and SIGTERM
or SIGINT stopping the learner at the next update boundary
(`LAST_RUN_STATS["resilience"]["preempted"]`; Sebulba has no checkpoint).
The ops plane: the pipeline's heartbeat board is registered with the health
monitor (`/healthz` with `logger.telemetry.http.enabled`) and the status
board follows the windows.

`arch.fleet.enabled` (resilience/fleet.py), as the JAX runner wires it: the
runner joins the process group that `arch.distributed` (or torchrun's
environment) declares, over gloo (the group only carries the fleet's store
and host-side gathers: each process's Sebulba run trains on its own cards),
the collects fail fast on a declared partition, a local SIGTERM becomes this
process's flag instead of a stop, and at every eval-window boundary the
processes exchange their wall times (`observe_window_wall`, a
`process_allgather`) and vote through the store (`agree_at_window`): every
process stops at the same window. `LAST_RUN_STATS["fleet_decisions"]` lists
each window's agreed verdict. The learner's gradients are not reduced across
processes (one process's learner devices only).

Refused by name: the compile cache layer, the "group" mesh axis, and (ROADMAP
C24) the knobs these learners never read: `system.replay.impl: sharded` (the JAX Sebulba PPO and IMPALA never
read `system.replay`), and on PPO `system.fused_update` and
`system.clip_value`.
"""

from __future__ import annotations

import collections
import copy
import logging
import queue
import sys
import threading
import time
from functools import partial
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams, PPOTransition
from stoix_tpu_torch.envs.factory import make_factory
from stoix_tpu_torch.evaluator import (
    get_distribution_act_fn, get_ff_evaluator_fn, get_stateful_evaluator_fn,
)
from stoix_tpu_torch.observability import (
    RunStats, annotate, flightrec, get_health_monitor, get_logger, get_registry,
    get_status_board, goodput, span,
)
from stoix_tpu_torch.ops import losses, running_statistics, scan_kernels
from stoix_tpu_torch.ops import truncated_generalized_advantage_estimation
from stoix_tpu_torch.parallel.distributed import maybe_initialize_distributed
from stoix_tpu_torch.parallel.roles import MeshRoles
from stoix_tpu_torch.resilience import (
    PreemptionHandler, faultinject, fleet, guards, integrity, preflight,
)
from stoix_tpu_torch.resilience.errors import EvaluatorStallError
from stoix_tpu_torch.resilience.supervisor import supervisor_from_config
from stoix_tpu_torch.sebulba.core import (
    EVALUATOR_ERRORS,
    PUT_TIMEOUT_S,
    AsyncEvaluator,
    OffPolicyPipeline,
    OnPolicyPipeline,
    ParameterServer,
    ThreadLifetime,
    place,
)
from stoix_tpu_torch.systems import anakin
from stoix_tpu_torch.systems.ppo.anakin.ff_ppo import build_networks, make_apply_fn, make_optimizers
from stoix_tpu_torch.systems.runner import (
    resolve_device, run_preflight_checks, unported_arch_keys,
)
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.logger import LogEvent, StoixLogger
from stoix_tpu_torch.utils.timing import TimingTracker
from stoix_tpu_torch.utils.training import apply_updates
from stoix_tpu_torch.utils.tree import tree_map, tree_merge_leading_dims, tree_stack

# Stats of the most recent run_experiment call in this process: the
# post-compile steady-state env-steps/s, whole-run fps, learn steps, the
# timings, and the resilience block (crashes, restarts, evaluator errors).
LAST_RUN_STATS = RunStats()

ACTOR_CRASHES = "stoix_tpu_sebulba_actor_crashes_total"
ACTOR_RESTARTS = "stoix_tpu_resilience_actor_restarts_total"
PARAMS_TIMEOUT_S = 180.0  # an actor's wait for a param version
_LOG = logging.getLogger("stoix_tpu_torch.sebulba")


class CoreLearnerState(NamedTuple):
    params: ActorCriticParams  # on the first learner device
    opt_states: ActorCriticOptStates
    generator: Any  # torch.Generator on the first learner device: the epochs' permutations
    obs_stats: Any  # running_statistics.RunningStatisticsState


# ---------------------------------------------------------------- shards


def same_device(devices: Sequence[torch.device]) -> bool:
    return all(torch.device(d) == torch.device(devices[0]) for d in devices)


def shard_sum(parts: Sequence[Any], device: torch.device) -> Any:
    """The shards' trees (gradient dicts, scalars) summed in shard order on
    `device`; one shard's as it is."""
    if len(parts) == 1:
        return parts[0]
    total = place(parts[0], device)
    for part in parts[1:]:
        total = tree_map(lambda a, b: a + b, total, place(part, device))
    return total


def shard_mean(parts: Sequence[Any], device: torch.device) -> Any:
    """The JAX package's pmean over "data" of per-shard values: their sum
    divided by their count."""
    if len(parts) == 1:
        return parts[0]
    return tree_map(lambda x: x / len(parts), shard_sum(parts, device))


def _cat_shards(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(list(parts), dim=1)


def _split_shards(x: torch.Tensor, widths: Sequence[int]) -> List[torch.Tensor]:
    return [x] if len(widths) == 1 else list(x.split(list(widths), dim=1))


def standardize(advantages: torch.Tensor) -> torch.Tensor:
    """Advantages standardised over their own batch (population std, as
    jnp.std)."""
    return (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)


def assemble_batch(payloads: Sequence[List[PPOTransition]]) -> List[PPOTransition]:
    """The learner's batch from every actor's payload (a list of per-learner-
    device [T, E_a/n] shards): per learner device, the actors' shards
    concatenated on the ENV axis (1) in actor order, never on the time axis,
    which would let GAE bootstrap across the seam."""
    return [tree_map(lambda *xs: torch.cat(xs, dim=1), *shards) for shards in zip(*payloads)]


def normalized_shards(shards: Sequence[Any], stats: Any, devices: Sequence[torch.device],
                      enabled: bool) -> Tuple[List[Any], Any]:
    """With `enabled`: each shard's obs and next_obs normalised with the
    pre-update statistics, and the statistics with every shard's raw
    observations folded in (each shard's sums first, then summed over the
    shards, as the psum over "data"). Else the shards and statistics as
    they are."""
    if not enabled:
        return list(shards), stats
    out = []
    for shard, device in zip(shards, devices):
        local = place(stats, device)
        out.append(shard._replace(
            obs=running_statistics.normalize_observation(shard.obs, local),
            next_obs=running_statistics.normalize_observation(shard.next_obs, local)))
    views = [shard.obs.agent_view.to(devices[0]) for shard in shards]
    if len(views) == 1:
        folded = running_statistics.update(stats, views[0], std_min_value=5e-4,
                                           std_max_value=5e4)
    else:
        folded = running_statistics.update(stats, torch.stack(views, dim=1), replica_axis=1,
                                           std_min_value=5e-4, std_max_value=5e4)
    return out, folded


def _leaf_copies(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


# ---------------------------------------------------------------- the PPO learn step


class PPOLearnStep:
    """`step(state, shards, permutations=None) -> (state, metrics)`: one
    Sebulba PPO update over the learner devices' shards (the JAX package's
    `get_learn_step` under `shard_map`). `permutations[epoch]` replaces the
    epoch's draw from the learner's generator (the tests feed JAX's)."""

    def __init__(self, actor_apply: Callable, critic_apply: Callable, optims: Tuple[Any, Any],
                 config: Any, learner_devices: Sequence[torch.device]):
        self.actor_apply, self.critic_apply = actor_apply, critic_apply
        self.actor_optim, self.critic_optim = optims
        self.devices = [torch.device(d) for d in learner_devices]
        system = config.system
        self.gamma = float(system.gamma)
        self.gae_lambda = float(system.gae_lambda)
        self.clip_eps = float(system.clip_eps)
        self.ent_coef = float(system.ent_coef)
        self.vf_coef = float(system.vf_coef)
        self.standardize_advantages = bool(system.get("standardize_advantages", True))
        self.multistep_impl = str(system.get("multistep_impl", "scan"))
        self.normalize_obs = bool(system.get("normalize_observations", False))
        self.guard_mode = guards.resolve_mode(config)
        self.epochs = int(system.epochs)
        self.num_minibatches = int(system.num_minibatches)

    def prepare(self, state: CoreLearnerState, shards: Sequence[PPOTransition]):
        """(normalised shards, the new statistics, each shard's advantages,
        each shard's targets)."""
        shards, obs_stats = normalized_shards(shards, state.obs_stats, self.devices,
                                              self.normalize_obs)
        with torch.no_grad():
            v_t = [self.critic_apply(place(state.params.critic_params, d), s.next_obs)
                   for s, d in zip(shards, self.devices)]
            parts = []
            for s, v in zip(shards, v_t):
                parts.append((s.reward, self.gamma * (1.0 - s.done.to(torch.float32)), s.value,
                              v, s.truncated.to(torch.float32)))
            if same_device(self.devices):
                # The shards' columns are independent: one GAE call over all.
                groups = [tuple(_cat_shards(xs) for xs in zip(*parts))]
            else:
                groups = parts
            advantages, targets = [], []
            for r_t, d_t, v_tm1, v_tp1, trunc in groups:
                adv, tgt = truncated_generalized_advantage_estimation(
                    r_t, d_t, self.gae_lambda, v_tm1=v_tm1, v_t=v_tp1, truncation_t=trunc,
                    impl=self.multistep_impl)
                advantages.append(adv)
                targets.append(tgt)
            if same_device(self.devices):
                widths = [s.reward.shape[1] for s in shards]
                advantages = _split_shards(advantages[0], widths)
                targets = _split_shards(targets[0], widths)
            if self.standardize_advantages:
                advantages = [standardize(a) for a in advantages]
        return shards, obs_stats, advantages, targets

    def policy_loss(self, policy: Any, obs: Any, action: torch.Tensor,
                    old_log_prob: torch.Tensor, advantages: torch.Tensor,
                    target: Optional[ActorCriticParams]) -> torch.Tensor:
        """The clipped surrogate (`target`, IMPACT's, is unused here)."""
        return losses.ppo_clip_loss(policy.log_prob(action), old_log_prob, advantages,
                                    self.clip_eps)

    def shard_gradients(self, params: ActorCriticParams, batch: Tuple,
                        target: Optional[ActorCriticParams] = None) -> Tuple:
        """One shard's actor and critic gradients on one minibatch, two
        backward passes, and its (guard loss, actor loss, value loss,
        entropy)."""
        obs, action, old_log_prob, old_value, advantages, targets = batch
        with torch.enable_grad():
            actor_params = _leaf_copies(params.actor_params)
            policy = self.actor_apply(actor_params, obs)
            loss_actor = self.policy_loss(policy, obs, action, old_log_prob, advantages, target)
            entropy = policy.entropy().mean()
            actor_total = loss_actor - self.ent_coef * entropy
            actor_grads = dict(zip(actor_params, torch.autograd.grad(
                actor_total, list(actor_params.values()))))
            critic_params = _leaf_copies(params.critic_params)
            value = self.critic_apply(critic_params, obs)
            value_loss = losses.clipped_value_loss(value, old_value, targets, self.clip_eps)
            critic_total = self.vf_coef * value_loss
            critic_grads = dict(zip(critic_params, torch.autograd.grad(
                critic_total, list(critic_params.values()))))
        terms = tuple(x.detach() for x in (actor_total + critic_total, loss_actor, value_loss,
                                           entropy))
        return actor_grads, critic_grads, terms

    @annotate("ppo_minibatch")
    def minibatch(self, params: ActorCriticParams, opt_states: ActorCriticOptStates,
                  batches: Sequence[Tuple], target: Optional[ActorCriticParams] = None):
        """Every shard's gradients on its minibatch, summed over the shards
        (ROADMAP C25), then one clip + Adam step and the guard."""
        home = self.devices[0]
        per_shard = [self.shard_gradients(place(params, d), batch,
                                          None if target is None else place(target, d))
                     for batch, d in zip(batches, self.devices)]
        actor_grads = shard_sum([g[0] for g in per_shard], home)
        critic_grads = shard_sum([g[1] for g in per_shard], home)
        guard_loss, loss_actor, value_loss, entropy = shard_mean([g[2] for g in per_shard], home)
        actor_updates, actor_opt = self.actor_optim.update(actor_grads, opt_states.actor_opt_state)
        critic_updates, critic_opt = self.critic_optim.update(critic_grads,
                                                              opt_states.critic_opt_state)
        new = (ActorCriticParams(apply_updates(params.actor_params, actor_updates),
                                 apply_updates(params.critic_params, critic_updates)),
               ActorCriticOptStates(actor_opt, critic_opt))
        metrics = {"actor_loss": loss_actor, "value_loss": value_loss, "entropy": entropy}
        if self.guard_mode != "off":
            new, guard_metrics = guards.guard_update(
                self.guard_mode, new=new, old=(params, opt_states), loss=guard_loss,
                grads=(actor_grads, critic_grads))
            metrics.update(guard_metrics)
        return new[0], new[1], metrics

    def __call__(self, state: CoreLearnerState, shards: Sequence[PPOTransition],
                 permutations: Optional[Sequence[torch.Tensor]] = None):
        return self.run(state, shards, permutations)

    def run(self, state: CoreLearnerState, shards: Sequence[PPOTransition],
            permutations: Optional[Sequence[torch.Tensor]] = None,
            target: Optional[ActorCriticParams] = None):
        shards, obs_stats, advantages, targets = self.prepare(state, shards)
        flat = [tree_merge_leading_dims((s.obs, s.action, s.log_prob, s.value, a, g), 2)
                for s, a, g in zip(shards, advantages, targets)]
        batch_size = advantages[0].numel()
        params, opt_states = state.params, state.opt_states
        per_epoch = []
        for epoch in range(self.epochs):
            if permutations is not None:
                permutation = permutations[epoch].to(self.devices[0])
            else:
                permutation = torch.randperm(batch_size, generator=state.generator,
                                             device=self.devices[0])
            minibatches = [tree_map(lambda x, p=permutation.to(d): x.index_select(0, p).reshape(
                (self.num_minibatches, -1) + x.shape[1:]), f)
                for f, d in zip(flat, self.devices)]
            per_minibatch = []
            for i in range(self.num_minibatches):
                params, opt_states, metrics = self.minibatch(
                    params, opt_states, [tree_map(lambda x: x[i], mb) for mb in minibatches],
                    target)
                per_minibatch.append(metrics)
            per_epoch.append(tree_stack(per_minibatch))
        return (CoreLearnerState(params, opt_states, state.generator, obs_stats),
                tree_stack(per_epoch))


def get_learn_step(actor_apply, critic_apply, optims, config, learner_devices) -> PPOLearnStep:
    return PPOLearnStep(actor_apply, critic_apply, optims, config, learner_devices)


class ImpactLearnStep(PPOLearnStep):
    """`step(state, target_params, shards, permutations=None)`: the IMPACT
    update (the JAX package's `get_impact_learn_step`): PPO's learn step
    with the target params as a third input and `losses.impact_loss`, taken
    against the target policy and weighted by the clipped target/behaviour
    ratio, as the actor loss. `log_prob` in the batch is the BEHAVIOUR
    log-prob of whichever version collected it, which is what makes
    re-stepping a buffered batch sound."""

    def __init__(self, actor_apply: Callable, critic_apply: Callable, optims: Tuple[Any, Any],
                 config: Any, learner_devices: Sequence[torch.device], rho_clip: float):
        super().__init__(actor_apply, critic_apply, optims, config, learner_devices)
        self.rho_clip = float(rho_clip)

    def policy_loss(self, policy, obs, action, behavior_log_prob, advantages, target):
        # The target policy's log-probs on the same (normalised) obs, with no
        # gradient into them.
        with torch.no_grad():
            target_log_prob = self.actor_apply(target.actor_params, obs).log_prob(action)
        return losses.impact_loss(policy.log_prob(action), behavior_log_prob, target_log_prob,
                                  advantages, self.clip_eps, self.rho_clip)

    def __call__(self, state: CoreLearnerState, target_params: ActorCriticParams,
                 shards: Sequence[PPOTransition],
                 permutations: Optional[Sequence[torch.Tensor]] = None):
        return self.run(state, shards, permutations, target=target_params)


def get_impact_learn_step(actor_apply, critic_apply, optims, config, learner_devices,
                          rho_clip: float) -> ImpactLearnStep:
    return ImpactLearnStep(actor_apply, critic_apply, optims, config, learner_devices, rho_clip)


# ---------------------------------------------------------------- IMPACT scheduling


class ImpactSettings(NamedTuple):
    """Validated `system.impact` knobs (IMPACT stale-trajectory reuse)."""

    target_update_interval: int
    rho_clip: float
    max_staleness: int
    max_reuse: int
    buffer_size: int


def impact_settings_from_config(config: Any) -> Optional[ImpactSettings]:
    """None unless `system.impact.enabled`; the JAX package's three
    ValueErrors for settings out of range."""
    raw = dict(config.system.get("impact") or {})
    if not bool(raw.get("enabled", False)):
        return None
    settings = ImpactSettings(
        target_update_interval=int(raw.get("target_update_interval", 4)),
        rho_clip=float(raw.get("rho_clip", 2.0)),
        max_staleness=int(raw.get("max_staleness", 4)),
        max_reuse=int(raw.get("max_reuse", 2)),
        buffer_size=int(raw.get("buffer_size", 4)),
    )
    if settings.target_update_interval < 1:
        raise ValueError("system.impact.target_update_interval must be >= 1 "
                         f"(got {settings.target_update_interval})")
    if settings.rho_clip < 1.0:
        raise ValueError("system.impact.rho_clip must be >= 1.0 — clipping the IS ratio "
                         f"below 1 would down-weight FRESH data (got {settings.rho_clip})")
    if settings.max_staleness < 1 or settings.max_reuse < 0 or settings.buffer_size < 1:
        raise ValueError("system.impact: max_staleness/buffer_size must be >= 1 and "
                         f"max_reuse >= 0 (got {settings})")
    return settings


class ImpactBatch(NamedTuple):
    """One learner step's worth of data on the IMPACT path."""

    batch: Any  # the assembled batch: one [T, E/n] shard a learner device
    behavior_version: int  # the oldest param version that collected it
    fresh: bool  # False when re-stepping a buffered batch


class ImpactIngest:
    """Fresh/stale scheduling for the IMPACT learner. It prefers a FULL set
    of fresh payloads (`need` of them, from any mix of actors: their shapes
    are the same); when fresh data is late it re-steps the newest buffered
    batch instead of blocking; only with nothing to re-step does it block in
    wait_for_data. A buffered batch retires once its reuse budget is spent,
    and the buffer is dropped once its newest entry lags the learner by more
    than `max_staleness` versions."""

    def __init__(self, pipeline: Any, need: int, settings: ImpactSettings):
        self._pipeline = pipeline
        self._need = need
        self._settings = settings
        self._pending: List[Any] = []  # (behavior_version, payload), oldest first
        # [behavior_version, batch, reuse_left]; an append past capacity
        # retires the oldest (stalest) entry.
        self._buffer: collections.deque = collections.deque(maxlen=settings.buffer_size)
        registry = get_registry()
        self._reused = registry.counter(
            "stoix_tpu_impact_reused_batches_total",
            "Learner updates that re-stepped a buffered stale batch because fresh "
            "rollouts were late")
        self._dropped = registry.counter(
            "stoix_tpu_impact_dropped_batches_total",
            "Buffered batches retired for exceeding system.impact.max_staleness")

    def _ingest(self, items: List[Any]) -> None:
        for _actor_id, (version, payload) in items:
            self._pending.append((version, payload))

    def _pop_reusable(self, current_version: int) -> Optional[ImpactBatch]:
        while self._buffer:
            # Newest first: if IT is too stale, everything behind it is too.
            version, batch, reuse_left = self._buffer[-1]
            if current_version - version > self._settings.max_staleness:
                self._dropped.inc(len(self._buffer))
                self._buffer.clear()
                return None
            if reuse_left <= 0:
                self._buffer.pop()
                continue
            self._buffer[-1][2] = reuse_left - 1
            self._reused.inc()
            return ImpactBatch(batch, version, fresh=False)
        return None

    def next_batch(self, assemble: Callable[[List[Any]], Any], current_version: int,
                   timeout: float = 180.0) -> ImpactBatch:
        """One update's batch: fresh when a full payload set is there (or
        arrives while nothing can be re-stepped), else a buffered one."""
        self._ingest(self._pipeline.poll(max_items=4 * self._need, timeout=0.0))
        if len(self._pending) < self._need:
            reusable = self._pop_reusable(current_version)
            if reusable is not None:
                return reusable
            while len(self._pending) < self._need:
                self._ingest(self._pipeline.wait_for_data(timeout=timeout))
        take, self._pending = self._pending[:self._need], self._pending[self._need:]
        version = min(v for v, _ in take)
        batch = assemble([p for _, p in take])
        if self._settings.max_reuse > 0:
            self._buffer.append([version, batch, self._settings.max_reuse])
        return ImpactBatch(batch, version, fresh=True)


# ---------------------------------------------------------------- networks


def ppo_networks(config: Any, env: Any, generator: torch.Generator):
    """(actor, critic) modules from the network config, the head taking the
    env's action space; the weights draw from `generator`, the actor's first
    (the Anakin systems' `build_networks`)."""
    return build_networks(env, config, generator)


# ---------------------------------------------------------------- refusals


def check_ported(config: Any) -> None:
    """NotImplementedError, naming the keys, for everything the Sebulba
    runners of the port do not run; then arms the fault plan
    (`STOIX_TPU_FAULT` over `arch.fault_spec`), refusing any fault but
    `actor_crash` and `queue_stall`, naming it."""
    unported = unported_arch_keys(config)
    if unported:
        raise NotImplementedError("not ported: " + ", ".join(unported))
    faultinject.check_sebulba_plan(faultinject.configure(config.arch.get("fault_spec")))


def refuse_replay_impl(config: Any) -> None:
    """ROADMAP C24: the JAX Sebulba PPO and IMPALA never read
    `system.replay`; the port refuses `replay.impl: sharded` there rather
    than ignore it."""
    if str((config.system.get("replay") or {}).get("impl", "local")) == "sharded":
        raise NotImplementedError(
            "system.replay.impl=sharded: the JAX package's Sebulba PPO and IMPALA never read "
            "system.replay (ROADMAP C24); the sharded replay serves Sebulba ff_dqn")


def refuse_integrity_without_probe(config: Any) -> None:
    """The port keeps ONE copy of the Sebulba learner state (on the first
    learner device; the JAX runner replicates it over the learner devices),
    so the replica fingerprints the JAX runner compares have no second
    witness here and could never reach a verdict. The check that can is
    the determinism probe: update 0's (state, batch), held, replayed through
    the learn step at the eval boundaries and fingerprinted bitwise against
    update 0's own result. `arch.integrity.enabled` without it is refused."""
    settings = integrity.settings_from_config(config)
    if settings.enabled and settings.determinism_probe_interval <= 0:
        raise NotImplementedError(
            "arch.integrity.enabled on Sebulba needs arch.integrity.determinism_probe_interval "
            "> 0: the port keeps one copy of the Sebulba learner state, so replica "
            "fingerprints have nothing to compare, and the determinism probe is its check")


def ppo_refusals(config: Any) -> None:
    """ROADMAP C24: `system.fused_update` and `system.clip_value`, which the
    JAX Sebulba learner never reads (it always takes two backward passes
    and clips its value loss), are refused away from their defaults."""
    bad = [f"system.{key}={config.system.get(key)}"
           for key, default in (("fused_update", False), ("clip_value", True))
           if config.system.get(key, default) not in (default, None, "~")]
    if bad:
        raise NotImplementedError(f"{', '.join(bad)}: the JAX package's Sebulba ff_ppo never "
                                  "reads it (ROADMAP C24)")


# ---------------------------------------------------------------- the actor


def await_params(param_server: ParameterServer, actor_id: int, lifetime: ThreadLifetime,
                 versioned: bool = False):
    """The actor's next param version (a VersionedParams with `versioned`),
    polled so a stop is noticed; None on the shutdown sentinel or a stop.
    Raises queue.Empty past PARAMS_TIMEOUT_S."""
    get = param_server.get_params_versioned if versioned else param_server.get_params
    deadline = time.monotonic() + PARAMS_TIMEOUT_S
    while True:
        try:
            return get(actor_id, timeout=0.5)
        except queue.Empty:
            if lifetime.should_stop():
                return None
            if time.monotonic() > deadline:
                raise


def supervised_actor(body: Callable[..., None], actor_id: int, lifetime: ThreadLifetime,
                     supervisor: Any, *args: Any) -> None:
    """An actor thread's `body(*args)`: a crash is counted, logged, and
    reported to the supervisor (which restarts the actor or fails the run),
    or stops the run where there is none."""
    try:
        body(*args)
    except Exception as exc:  # noqa: BLE001 — every crash is counted and supervised
        import traceback

        get_registry().counter(ACTOR_CRASHES, "Actor threads that died with an exception").inc(
            labels={"actor": str(actor_id)})
        _LOG.error("[actor-%d] CRASHED:\n%s", actor_id, traceback.format_exc())
        if supervisor is not None:
            supervisor.report_crash(actor_id, exc)
        else:
            lifetime.stop()


def rollout_thread(actor_id: int, actor_device: torch.device, env_factory: Any,
                   apply_fns: Callable[[torch.device], Tuple[Callable, Callable]], config: Any,
                   pipeline: Any, param_server: ParameterServer,
                   learner_devices: Sequence[torch.device], lifetime: ThreadLifetime,
                   seed: int, metrics_sink: "queue.Queue", supervisor: Any = None) -> None:
    supervised_actor(_rollout_body, actor_id, lifetime, supervisor, actor_id, actor_device,
                     env_factory, apply_fns, config, pipeline, param_server, learner_devices,
                     lifetime, seed, metrics_sink, TimingTracker())


def _rollout_body(actor_id, actor_device, env_factory, apply_fns, config, pipeline,
                  param_server, learner_devices, lifetime, seed, metrics_sink, timer):
    envs_per_actor = int(config.arch.actor.envs_per_actor)
    rollout_length = int(config.system.rollout_length)
    normalize_obs = bool(config.system.get("normalize_observations", False))
    # IMPACT: params come with their version, and every payload is tagged
    # with the version that collected it (the learner's staleness).
    impact_on = impact_settings_from_config(config) is not None
    envs = env_factory(envs_per_actor)
    timestep = envs.reset(seed=seed)
    generator = anakin.make_generator(seed, actor_device)
    # The thread's own copies of the networks: functional_call swaps a
    # module's parameters while it runs, so no two threads may share one.
    actor_apply, critic_apply = apply_fns(actor_device)

    @torch.no_grad()
    def act(bundle, observation):
        params, obs_stats = bundle
        if normalize_obs:
            observation = running_statistics.normalize_observation(observation, obs_stats)
        policy = actor_apply(params.actor_params, observation)
        value = critic_apply(params.critic_params, observation)
        action = policy.sample(generator)
        return action, policy.log_prob(action), value

    versioned = await_params(param_server, actor_id, lifetime, versioned=True)
    if versioned is None:
        return
    behavior_version, bundle = versioned
    rollout_idx = 0
    n_learners = len(learner_devices)
    while not lifetime.should_stop():
        # Chaos injection points (no-ops unless a fault plan is armed).
        faultinject.maybe_crash_actor(actor_id, rollout_idx)
        faultinject.maybe_stall_queue(actor_id, rollout_idx, should_abort=lifetime.should_stop)
        # Pipelining: the second rollout skips the fetch, so the actors run
        # one rollout ahead while the learner computes.
        if rollout_idx > 1:
            with timer.time("get_params"):
                versioned = await_params(param_server, actor_id, lifetime, versioned=True)
            if versioned is None:
                break
            behavior_version, bundle = versioned
        traj: List[PPOTransition] = []
        infos = []
        with span("actor_rollout", actor=actor_id, idx=rollout_idx), timer.time("rollout"):
            for _ in range(rollout_length):
                with timer.time("inference"):
                    # The envs live on the host: their observations move to
                    # the actor device for inference.
                    obs_local = place(timestep.observation, actor_device)
                    action, log_prob, value = act(bundle, obs_local)
                with timer.time("env_step"):
                    next_timestep = envs.step(action)
                host = PPOTransition(
                    done=next_timestep.discount == 0.0,
                    truncated=next_timestep.last() & (next_timestep.discount != 0.0),
                    action=action, value=value, reward=next_timestep.reward,
                    log_prob=log_prob, obs=obs_local,
                    next_obs=next_timestep.extras["next_obs"], info={})
                # Every field on the actor device before the [T, E] stack.
                traj.append(place(host, actor_device))
                infos.append(next_timestep.extras["episode_metrics"])
                timestep = next_timestep

        with span("actor_prepare_data", actor=actor_id), timer.time("prepare_data"):
            stacked = tree_stack(traj)
            # The env axis split over the learner devices, one shard each.
            payload = [tree_map(lambda x, i=i, d=d: x.chunk(n_learners, dim=1)[i].to(d),
                                stacked) for i, d in enumerate(learner_devices)]
        with timer.time("queue_put"):
            try:
                if impact_on:
                    pipeline.push(actor_id, (behavior_version, payload), timeout=PUT_TIMEOUT_S)
                else:
                    pipeline.send_rollout(actor_id, payload, timeout=PUT_TIMEOUT_S)
            except queue.Full:
                if lifetime.should_stop():
                    break
                raise
        metrics_sink.put({
            "episode_metrics": tree_map(lambda x: x.cpu().numpy(), tree_stack(infos)),
            "timings": {**timer.all_means(prefix=f"actor{actor_id}_"),
                        **timer.all_percentiles(prefix=f"actor{actor_id}_")},
        })
        rollout_idx += 1


# ---------------------------------------------------------------- the runner


class SebulbaSetup(NamedTuple):
    """What `learner_setup` builds: the initial learner state, the learn
    step, a factory of per-thread apply functions, and the evaluator's
    seed."""

    state: CoreLearnerState
    learn_step: Callable
    thread_apply_fns: Callable[[torch.device], Tuple[Callable, Callable]]
    eval_seed: int


def learner_setup(config: Any, env: Any, learner_devices: Sequence[torch.device],
                  networks_builder: Optional[Callable] = None,
                  learn_step_builder: Optional[Callable] = None) -> SebulbaSetup:
    """The learner of a Sebulba run: networks built on the CPU from the run
    seed's first child seed and moved to the first learner device, the clip +
    Adam optimizers, zeroed observation statistics, the permutation generator
    and the learn step. `env` sizes the networks (a probe env of the run's
    factory). `config.arch.num_updates` must be set (the learning-rate
    decay reads it)."""
    init_seed, learn_seed, eval_seed = anakin.make_seeds(int(config.arch.seed), 3)
    actor, critic = (networks_builder or ppo_networks)(
        config, env, anakin.make_generator(init_seed, torch.device("cpu")))
    home = torch.device(learner_devices[0])
    actor.to(home)
    critic.to(home)
    apply_fns = make_apply_fn(actor), make_apply_fn(critic)
    optims = make_optimizers(config)
    params = ActorCriticParams({k: v.detach() for k, v in actor.named_parameters()},
                               {k: v.detach() for k, v in critic.named_parameters()})
    opt_states = ActorCriticOptStates(optims[0].init(params.actor_params),
                                      optims[1].init(params.critic_params))
    obs_stats = running_statistics.init_state(
        tree_map(lambda x: x.to(home), env.observation_value().agent_view))
    state = CoreLearnerState(params, opt_states, anakin.make_generator(learn_seed, home),
                             obs_stats)
    learn_step = (learn_step_builder or get_learn_step)(*apply_fns, optims, config,
                                                        learner_devices)

    def thread_apply_fns(device: torch.device) -> Tuple[Callable, Callable]:
        """(actor_apply, critic_apply) over a thread's own copy of the
        networks on `device` (one deepcopy, so a shared torso stays shared):
        `functional_call` swaps a module's parameters while it runs, so the
        learner, each actor and the evaluator each need their own."""
        own_actor, own_critic = copy.deepcopy((actor, critic))
        return make_apply_fn(own_actor.to(device)), make_apply_fn(own_critic.to(device))

    return SebulbaSetup(state, learn_step, thread_apply_fns, eval_seed)


def sebulba_devices(config: Any, device: Union[str, torch.device]) -> List[torch.device]:
    """The devices MeshRoles indexes: every visible card under CUDA (raising
    without one), or on another device type as many copies of it as the
    config's largest device id needs."""
    device = resolve_device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    arch = config.arch
    ids = [0, int(arch.get("evaluator_device_id", 0) or 0)]
    for role in ("actor", "learner"):
        ids += [int(i) for i in ((arch.get(role) or {}).get("device_ids") or [])]
    for spec in dict(arch.get("roles") or {}).values():
        ids += [int(i) for i in ((spec or {}).get("device_ids") or [])]
    return [device] * (max(ids) + 1)


def synchronize(devices: Sequence[torch.device]) -> None:
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def sebulba_budget(config: Any, num_actors: int) -> int:
    """The JAX package's Sebulba budget accounting, written into `config`:
    each actor's envs, `num_updates` from `total_timesteps` when unset,
    `total_timesteps` rounded to whole updates, the updates an eval window.
    Returns the env steps an update."""
    config.arch.actor.envs_per_actor = int(config.arch.total_num_envs) // num_actors
    steps_per_update = int(config.system.rollout_length) * int(config.arch.total_num_envs)
    if config.arch.get("num_updates") in (None, "~"):
        config.arch.num_updates = max(
            1, int(float(config.arch.total_timesteps)) // steps_per_update)
    config.arch.total_timesteps = int(config.arch.num_updates) * steps_per_update
    num_evaluation = max(1, int(config.arch.get("num_evaluation", 1)))
    config.arch.num_updates_per_eval = max(1, int(config.arch.num_updates) // num_evaluation)
    config.logger.system_name = config.system.system_name
    return steps_per_update


def make_evaluator(config: Any, eval_apply: Callable, env_factory: Any,
                   device: Any) -> Callable:
    """The run's evaluator, acting through `eval_apply(params, observation)`,
    by the JAX package's rule (its ff_ppo.py:823-853): a scenario with a
    tensor-env twin (a registry scenario, or an external suite, which
    `make_single` refuses) evaluates on the feed-forward evaluator over that
    env; any other (a gymnasium or envpool task id) on a pool of
    `env_factory`'s through `get_stateful_evaluator_fn`, acting on `device`."""
    from stoix_tpu_torch.envs.registry import ENV_REGISTRY, EXTERNAL_SUITES, make_single
    from stoix_tpu_torch.envs.wrappers import RecordEpisodeMetrics

    scenario = (config.env.scenario.name if hasattr(config.env.scenario, "name")
                else config.env.scenario)
    suite = config.env.get("env_name")
    act_fn = get_distribution_act_fn(config, eval_apply)
    if scenario in ENV_REGISTRY or suite in EXTERNAL_SUITES:
        eval_env = RecordEpisodeMetrics(make_single(
            scenario, suite, **dict(config.env.get("kwargs", {}) or {})))
        return get_ff_evaluator_fn(eval_env, act_fn, config)
    return get_stateful_evaluator_fn(env_factory, act_fn, config, device)


def resilience_counters() -> Tuple[Dict[str, Any], Dict[str, float]]:
    """The actor-crash, restart and evaluator-error counters, and their
    values now (a run reports what it adds)."""
    registry = get_registry()
    counters = {name: registry.counter(name) for name in (ACTOR_CRASHES, ACTOR_RESTARTS,
                                                          EVALUATOR_ERRORS)}
    return counters, {name: c.total() for name, c in counters.items()}


def resilience_stats(guard_mode: str, skipped_base: float, supervisor: Any,
                     counters: Dict[str, Any], base: Dict[str, float],
                     preempted: bool = False, fleet_on: bool = False) -> Dict[str, Any]:
    """`LAST_RUN_STATS["resilience"]` of a Sebulba run."""
    return {
        "fleet": fleet_on,
        "preempted": preempted,
        "update_guard": guard_mode,
        "skipped_updates": guards.skipped_counter().value() - skipped_base,
        "actor_restarts": supervisor.restart_count() if supervisor is not None else 0,
        "actor_crashes": counters[ACTOR_CRASHES].total() - base[ACTOR_CRASHES],
        "supervisor_restarts": counters[ACTOR_RESTARTS].total() - base[ACTOR_RESTARTS],
        "evaluator_errors": counters[EVALUATOR_ERRORS].total() - base[EVALUATOR_ERRORS],
        "resume_capable": False,
    }


def start_actors(make_thread: Callable[[int, Any], threading.Thread], actor_devices: List[Any],
                 actors_per_device: int, supervisor: Any, heartbeats: Any
                 ) -> List[threading.Thread]:
    """Every actor thread, `make_thread(actor_id, device)`, under the
    supervisor when there is one (it starts them and restarts a crashed
    one), else started here; returns the unsupervised threads."""
    threads: List[threading.Thread] = []
    for d_idx, actor_device in enumerate(actor_devices):
        for a_idx in range(actors_per_device):
            actor_id = d_idx * actors_per_device + a_idx
            make = partial(make_thread, actor_id, actor_device)
            if supervisor is not None:
                supervisor.register(actor_id, make)
            else:
                thread = make()
                thread.start()
                threads.append(thread)
    if supervisor is not None:
        supervisor.start_watchdog(heartbeats)
    return threads


def drain_episodes(metrics_sink: "queue.Queue", timings: Dict[str, float]) -> List[float]:
    """The returns of the episodes the actors finished since the last drain;
    their latest timings go into `timings`."""
    returns: List[float] = []
    while not metrics_sink.empty():
        m = metrics_sink.get_nowait()
        em = m["episode_metrics"]
        mask = em["is_terminal_step"].reshape(-1)
        if mask.any():
            returns.extend(em["episode_return"].reshape(-1)[mask].tolist())
        timings.update(m["timings"])
    return returns


def register_pipeline_board(config: Any, pipeline: Any) -> Any:
    """The ops plane of a Sebulba run: the pipeline's heartbeat board on the
    health monitor (`/healthz`), stale after `logger.telemetry.http.
    stale_after_s`; returns the monitor (unregister "sebulba-pipeline" at the
    end)."""
    http_cfg = dict(dict(config.logger.get("telemetry") or {}).get("http") or {})
    monitor = get_health_monitor()
    monitor.register_board("sebulba-pipeline", pipeline.heartbeats,
                           stale_after_s=float(http_cfg.get("stale_after_s", 60.0) or 60.0))
    return monitor


def shut_down(lifetime: ThreadLifetime, param_server: ParameterServer, pipeline: Any,
              supervisor: Any, actor_threads: List[threading.Thread],
              async_evaluator: AsyncEvaluator) -> None:
    """Stop the actors, unblock their puts, join them, and wait for the
    evaluator's last work (an evaluator still busy while another failure
    propagates is logged, not raised over it)."""
    lifetime.stop()
    param_server.shutdown()
    for _ in range(2):
        if pipeline.drain(timeout=0.5) == 0:
            break
    if supervisor is not None:
        supervisor.join_all(timeout=10.0)
    for thread in actor_threads:
        thread.join(timeout=10.0)
    failure_propagating = sys.exc_info()[0] is not None
    try:
        async_evaluator.wait_until_idle(timeout=120.0)
    except EvaluatorStallError:
        # Raising here would replace the failure that brought us here.
        if not failure_propagating:
            raise
        _LOG.error("[shutdown] evaluator still busy while handling another failure — "
                   "dropping its in-flight work")
    async_evaluator.thread.join(timeout=10.0)


def run_experiment(
    config: Any,
    device: Union[str, torch.device] = "cuda",
    learn_step_builder: Optional[Callable] = None,
    networks_builder: Optional[Callable] = None,
    refusals: Callable[[Any], None] = ppo_refusals,
) -> float:
    """Train a Sebulba system (PPO by default, IMPACT with
    `system.impact.enabled`; IMPALA passes its learn step and networks);
    returns the last evaluation's mean return. The roles' devices are cards
    unless the caller asks for the CPU."""
    LAST_RUN_STATS.clear()
    check_ported(config)
    refuse_replay_impl(config)
    refuse_integrity_without_probe(config)
    refusals(config)
    impact = impact_settings_from_config(config)
    if impact is not None and learn_step_builder is not None:
        raise ValueError("system.impact.enabled is incompatible with a custom "
                         "learn_step_builder: the IMPACT update takes (state, "
                         "target_params, batch), not (state, batch)")
    if impact is not None:
        learn_step_builder = partial(get_impact_learn_step, rho_clip=impact.rho_clip)
    guard_mode = guards.resolve_mode(config)
    scan_kernels.configure_from_config(config)
    # Preflight before any device work: the probe child, then the config's
    # cross-checks against the probed cards (the actor/learner split is the
    # kind of config it catches); a CPU run's devices are as many as its ids.
    pf = preflight.settings_from_config(config)
    run_preflight_checks(config, pf, torch.device(device), sebulba=True)
    roles = MeshRoles.from_config(config, devices=sebulba_devices(config, device))
    actor_devices = roles.role_devices("act")
    learner_devices = roles.role_devices("learn")
    evaluator_device = roles.device("evaluate")

    actors_per_device = int(config.arch.actor.actor_per_device)
    num_actors = len(actor_devices) * actors_per_device
    steps_per_update = sebulba_budget(config, num_actors)

    env_factory = make_factory(config)
    probe_envs = env_factory(1)
    config.system.action_dim = probe_envs.num_actions
    setup = learner_setup(config, probe_envs, learner_devices, networks_builder,
                          learn_step_builder)
    state, learn_step, thread_apply_fns = setup.state, setup.learn_step, setup.thread_apply_fns
    # The integrity sentinel: its probe holds update 0's input and result
    # and replays it at the eval boundaries (refuse_integrity_without_probe).
    sentinel = integrity.sentinel_from_config(config)
    if sentinel is not None:
        sentinel.bind(state)
        sentinel.install_excepthook()
    normalize_obs = bool(config.system.get("normalize_observations", False))
    eval_actor_apply = thread_apply_fns(evaluator_device)[0]

    def eval_apply(payload, observation):
        if normalize_obs:
            p, stats = payload
            return eval_actor_apply(p, running_statistics.normalize_observation(observation,
                                                                                stats))
        return eval_actor_apply(payload, observation)

    eval_fn = make_evaluator(config, eval_apply, env_factory, evaluator_device)
    eval_generator = anakin.make_generator(setup.eval_seed, evaluator_device)

    logger = StoixLogger(config)
    log_lock = threading.Lock()

    def log(metrics, t, t_eval, event):
        with log_lock:
            logger.log(metrics, t, t_eval, event)

    # StoixLogger reset the flight recorder: this run's identity and its
    # goodput ledger go on the fresh instances.
    ledger = goodput.GoodputLedger().start()
    goodput.set_active(ledger)
    recorder = flightrec.get_flight_recorder()
    recorder.set_context(architecture="sebulba", system=str(config.system.system_name),
                         seed=int(config.arch.seed))
    status = get_status_board()
    status.update({"run_id": f"{config.system.system_name}_seed{config.arch.seed}",
                   "architecture": "sebulba", "system": str(config.system.system_name),
                   "step": 0})
    lifetime = ThreadLifetime()
    fleet_coord = None
    if fleet.settings_from_config(config).enabled:
        # The group the launch declares, over gloo: it carries the fleet's
        # store and host-side gathers only.
        maybe_initialize_distributed(config, "cpu")
        fleet_coord = fleet.fleet_from_config(config).start()
    fleet_decisions: List[str] = []
    # IMPACT's learner never waits on a particular actor: the actors push to
    # one shared queue and ImpactIngest takes any full set.
    pipeline = (OnPolicyPipeline(num_actors, fleet=fleet_coord) if impact is None
                else OffPolicyPipeline(num_actors, fleet=fleet_coord))
    # One board for the whole run (actors, param server, evaluator, learner),
    # which /healthz reads through the health monitor.
    monitor = register_pipeline_board(config, pipeline)
    param_server = ParameterServer(actor_devices, actors_per_device,
                                   heartbeats=pipeline.heartbeats)
    metrics_sink: "queue.Queue" = queue.Queue()
    eval_results: List[float] = []

    def on_eval_result(metrics, params_used, t):
        log(metrics, t, len(eval_results), LogEvent.EVAL)
        eval_results.append(float(metrics["episode_return"].float().mean()))

    registry = get_registry()
    counters, counter_base = resilience_counters()
    async_evaluator = AsyncEvaluator(eval_fn, lifetime, on_eval_result,
                                     heartbeats=pipeline.heartbeats)
    async_evaluator.thread.start()
    param_server.distribute_params((state.params, state.obs_stats))

    supervisor = supervisor_from_config(config, lifetime, pipeline, param_server)

    def make_thread(actor_id: int, actor_device) -> threading.Thread:
        return threading.Thread(
            target=rollout_thread,
            args=(actor_id, actor_device, env_factory, thread_apply_fns, config,
                  pipeline, param_server, learner_devices, lifetime,
                  int(config.arch.seed) + 7919 * actor_id, metrics_sink, supervisor),
            name=f"actor-{actor_id}", daemon=True)

    actor_threads = start_actors(make_thread, actor_devices, actors_per_device, supervisor,
                                 pipeline.heartbeats)

    ingest, target_params, impact_stats = None, None, None
    if impact is not None:
        ingest = ImpactIngest(pipeline, num_actors, impact)
        # The target network: a recent online version, refreshed on the host
        # every target_update_interval updates.
        target_params = state.params
        staleness_gauge = registry.gauge(
            "stoix_tpu_impact_batch_staleness",
            "Param-version lag (learner version minus behavior version) of the batch "
            "consumed by the most recent IMPACT update")
        refreshes = registry.counter("stoix_tpu_impact_target_refreshes_total",
                                     "IMPACT target-network refreshes from the online params")
        impact_stats = {"updates": 0, "fresh_updates": 0, "reused_updates": 0,
                        "staleness_sum": 0, "max_staleness_seen": 0, "target_refreshes": 0}

    timer = TimingTracker()
    t_steps = 0
    learn_steps = 0
    timings: Dict[str, float] = {}
    skipped_base = guards.skipped_counter().value()
    steady_start_time = None  # set after the first eval window (post-compile)
    steady_start_steps = 0
    run_start_time = time.perf_counter()
    steady_end_time = run_start_time
    # SIGTERM and SIGINT stop the learner at the next update boundary and
    # run the orderly shutdown below.
    preempt = PreemptionHandler().install()
    preempted = False
    fleet_window_started = time.perf_counter()
    try:
        for update_idx in range(int(config.arch.num_updates)):
            fresh = True
            if ingest is None:
                with timer.time("rollout_get"):
                    payloads = pipeline.collect_rollouts()
                with span("learner_assemble", update=update_idx), timer.time("assemble"):
                    batch = assemble_batch(payloads)
            else:
                with span("impact_next_batch", update=update_idx), timer.time("rollout_get"):
                    got = ingest.next_batch(assemble_batch, param_server.version)
                batch, fresh = got.batch, got.fresh
                # The learner's version (the params it just trained) minus the
                # OLDEST behaviour version in the batch; it grows each time
                # the same buffered batch is re-stepped.
                staleness = param_server.version - got.behavior_version
                staleness_gauge.set(staleness)
                impact_stats["updates"] += 1
                impact_stats["fresh_updates" if fresh else "reused_updates"] += 1
                impact_stats["staleness_sum"] += staleness
                impact_stats["max_staleness_seen"] = max(impact_stats["max_staleness_seen"],
                                                         staleness)
            learn_args = (state, batch) if ingest is None else (state, target_params, batch)
            if sentinel is not None and update_idx == 0:
                sentinel.capture_probe_input(learn_args)
            with span("learner_update", update=update_idx), timer.time("learn"):
                state, train_metrics = learn_step(*learn_args)
                synchronize(learner_devices)
            if sentinel is not None and update_idx == 0:
                sentinel.record_probe_reference(sentinel.fingerprints(state))
            learn_steps += 1
            param_server.distribute_params((state.params, state.obs_stats))
            if ingest is not None and impact_stats["updates"] % impact.target_update_interval == 0:
                target_params = state.params
                impact_stats["target_refreshes"] += 1
                refreshes.inc()
            if fresh:
                # A re-stepped batch holds no NEW env frames: t_steps counts
                # env frames, not gradient steps.
                t_steps += steps_per_update
            guards.publish_guard_metrics(guard_mode, train_metrics, t_steps)
            ledger.note(goodput.SEBULBA_PHASE_MAP["rollout_get"], timer.latest("rollout_get"))
            if ingest is None:
                ledger.note(goodput.SEBULBA_PHASE_MAP["assemble"], timer.latest("assemble"))
            ledger.note(goodput.SEBULBA_PHASE_MAP["learn"], timer.latest("learn"))
            if fleet_coord is None:
                if preempt.stop_requested():
                    preempt.acknowledge(t_steps)
                    preempted = True
                    break
            else:
                # Never stop alone: the local SIGTERM becomes this process's
                # vote at the next window boundary; a declared partition
                # raises here, typed.
                fleet_coord.check_partition()
                if preempt.stop_requested():
                    fleet_coord.request_stop(
                        fleet.FLAG_PREEMPT, note=f"{preempt.signal_name} at update {update_idx}")

            if (update_idx + 1) % int(config.arch.num_updates_per_eval) == 0:
                ep_returns = drain_episodes(metrics_sink, timings)
                if ep_returns:
                    log({"episode_return": np.asarray(ep_returns)}, t_steps, update_idx,
                        LogEvent.ACT)
                log({k: v.mean() for k, v in train_metrics.items()}, t_steps, update_idx,
                    LogEvent.TRAIN)
                timings.update({**timer.all_means(prefix="learner_"),
                                **timer.all_percentiles(prefix="learner_")})
                log(dict(timings), t_steps, update_idx, LogEvent.MISC)
                eval_payload = ((state.params.actor_params, state.obs_stats) if normalize_obs
                                else state.params.actor_params)
                async_evaluator.submit(place(eval_payload, evaluator_device), eval_generator,
                                       t_steps)
                if steady_start_time is None:
                    steady_start_time = time.perf_counter()
                    steady_start_steps = t_steps
                window_idx = (update_idx + 1) // int(config.arch.num_updates_per_eval)
                status.update({"window": window_idx, "step": t_steps})
                recorder.record("window", window=window_idx, step=t_steps,
                                updates=update_idx + 1,
                                queue_wait_s=round(timer.mean("rollout_get"), 6),
                                learn_s=round(timer.mean("learn"), 6))
                corruption = None
                if sentinel is not None and sentinel.should_probe(window_idx):
                    corruption = sentinel.run_probe(lambda held: learn_step(*held)[0])
                    if corruption is not None:
                        recorder.record("integrity_verdict", window=window_idx, step=t_steps,
                                        detail=str(corruption))
                        if fleet_coord is not None:
                            fleet_coord.request_stop(fleet.FLAG_CORRUPT, note=str(corruption))
                if fleet_coord is not None:
                    # The window boundary: wall times for the skew gauges,
                    # then this window's stop vote through the store; every
                    # process decides from the same votes.
                    now = time.perf_counter()
                    fleet_coord.observe_window_wall(window_idx, now - fleet_window_started)
                    fleet_window_started = now
                    decision = fleet_coord.agree_at_window(window_idx)
                    fleet_decisions.append(decision.describe())
                    if decision.stop:
                        if corruption is not None:
                            raise corruption
                        if preempt.stop_requested():
                            preempt.acknowledge(t_steps)
                        else:
                            get_logger("stoix_tpu_torch.sebulba").warning(
                                "[fleet] %s — stopping at window %d in lockstep with the fleet",
                                decision.describe(), window_idx)
                        preempted = preempt.stop_requested()
                        break
                if corruption is not None:
                    raise corruption
        # Close the window BEFORE shutdown: joins and the evaluator's drain
        # must not deflate the steady-state number.
        steady_end_time = time.perf_counter()
    except KeyboardInterrupt:
        # The fleet monitor interrupts the main thread when a peer dies: the
        # typed error (exit 87 through the fleet's excepthook); an operator's
        # ^C re-raises as it is.
        if fleet_coord is not None and fleet_coord.partition_event.is_set():
            raise fleet_coord.partition_error from None
        raise
    finally:
        preempt.uninstall()
        goodput.set_active(None)
        monitor.unregister("sebulba-pipeline")
        if sentinel is not None:
            sentinel.deactivate()
        if fleet_coord is not None:
            fleet_coord.stop()
        shut_down(lifetime, param_server, pipeline, supervisor, actor_threads, async_evaluator)
        logger.close()

    if steady_start_time is not None and t_steps > steady_start_steps:
        steady = (t_steps - steady_start_steps) / (steady_end_time - steady_start_time)
        registry.gauge("stoix_tpu_sebulba_steps_per_sec_steady",
                       "Post-compile steady-state env-steps/sec of the most recent run").set(steady)
        LAST_RUN_STATS["steps_per_sec_steady"] = steady
        LAST_RUN_STATS["steady_window_steps"] = t_steps - steady_start_steps
    if t_steps > 0:
        fps = t_steps / max(steady_end_time - run_start_time, 1e-9)
        registry.gauge("stoix_tpu_sebulba_fps",
                       "Whole-run env-steps/sec (incl. compile) of the most recent run").set(fps)
        LAST_RUN_STATS["fps"] = fps
        LAST_RUN_STATS["total_env_steps"] = t_steps
    LAST_RUN_STATS.update({
        "learn_steps": learn_steps,
        "num_actors": num_actors,
        "envs_per_actor": int(config.arch.actor.envs_per_actor),
        "devices": {"act": [str(d) for d in actor_devices],
                    "learn": [str(d) for d in learner_devices],
                    "evaluate": str(evaluator_device)},
        "timings": timings,
        "eval_returns": list(eval_results),
        "history": logger.history,
        "resilience": resilience_stats(guard_mode, skipped_base, supervisor, counters,
                                       counter_base, preempted, fleet_on=fleet_coord is not None),
        # Each window's agreed fleet verdict (None with the fleet off).
        "fleet_decisions": fleet_decisions if fleet_coord is not None else None,
        "goodput": ledger.finalize(),
        "integrity": sentinel.stats() if sentinel is not None else integrity.disabled_stats(),
        # None when IMPACT is off, as in the JAX package.
        "impact": None if impact is None else {
            "rho_clip": impact.rho_clip,
            "target_update_interval": impact.target_update_interval,
            "max_staleness": impact.max_staleness,
            "max_reuse": impact.max_reuse,
            "updates": impact_stats["updates"],
            "fresh_updates": impact_stats["fresh_updates"],
            "reused_updates": impact_stats["reused_updates"],
            "mean_staleness": impact_stats["staleness_sum"] / max(1, impact_stats["updates"]),
            "max_staleness_seen": impact_stats["max_staleness_seen"],
            "target_refreshes": impact_stats["target_refreshes"],
        },
    })
    return eval_results[-1] if eval_results else 0.0


def main() -> float:
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/sebulba/default_ff_ppo.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
