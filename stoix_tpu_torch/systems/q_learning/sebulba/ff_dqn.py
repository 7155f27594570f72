"""Sebulba DQN, the off-policy ingestion path (counterpart of
stoix_tpu/systems/q_learning/sebulba/ff_dqn.py).

Actor threads run epsilon-greedy inference on their actor devices against
stateful env batches and PUSH transition shards through the
OffPolicyPipeline whenever a rollout chunk is ready; the learner owns the
sharded replay service (replay/service.py, one ring a learner device) and
SAMPLES it on its own schedule: no lockstep collect, so a slow or restarting
actor never stalls the learner.

Data path: an actor flattens its [T, E] chunk to T.E transitions, splits
them over the learner devices and moves each piece to its device; the
learner polls the pipeline and adds each payload to the service, so raw
experience lands on its shard and never moves again. The learner blocks on
the pipeline (`wait_for_data`, whose ActorStarvationError names the stalest
actor) only until the service can sample.

One learn step, `epochs` times, in the JAX package's order:

  1. the global draw from the service (B uniforms from the learner's
     generator, or given: the tests feed JAX's);
  2. with `replay.prioritized`, importance weights from the GLOBAL
     probabilities: `(N p)^-beta` (0 where p = 0), over their max over the
     shards;
  3. each shard's one-step Q-learning loss `0.5 mean(w td^2)` against the
     target network;
  4. the shards' gradients MEANED (ROADMAP C26: the JAX learn step runs its
     `shard_map` with `check_vma=False`, where `pmean` is a true mean, unlike
     the Sebulba PPO and IMPALA learners, whose gradients are summed, C25);
  5. global-norm clip + Adam (eps 1e-5), the Polyak target update (tau),
     the guard under `system.update_guard`;
  6. with `replay.prioritized`, |td| written back as the drawn slots' new
     priorities.

Params reach the actors every `replay.param_sync_interval` updates; an
actor takes the freshest queued version without ever waiting for one. The
supervisor restarts a crashed actor while the learner goes on sampling;
`arch.fault_spec` may arm `actor_crash` and `queue_stall`. The goodput
ledger, the flight recorder, preemption and the ops plane (the pipeline's
heartbeat board on the health monitor, the status board) are wired as in the
JAX runner; `arch.preflight`, `arch.integrity` and `arch.fleet`, which it
never reads, are refused.
`system.replay.impl` must be `sharded`, as in the JAX package.
"""

from __future__ import annotations

import copy
import queue
import sys
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from stoix_tpu_torch.base_types import OnlineAndTarget, Transition
from stoix_tpu_torch.envs.factory import make_factory
from stoix_tpu_torch.observability import (
    RunStats, annotate, flightrec, get_registry, get_status_board, goodput, span,
)
from stoix_tpu_torch.parallel.roles import MeshRoles
from stoix_tpu_torch.replay import ShardedReplayService, service_from_config
from stoix_tpu_torch.replay.core import pow_f32
from stoix_tpu_torch.resilience import PreemptionHandler, faultinject, guards
from stoix_tpu_torch.resilience.supervisor import supervisor_from_config
from stoix_tpu_torch.sebulba.core import (
    PUT_TIMEOUT_S,
    AsyncEvaluator,
    OffPolicyPipeline,
    ParameterServer,
    ThreadLifetime,
    place,
)
from stoix_tpu_torch.systems import anakin
from stoix_tpu_torch.systems.ppo.sebulba.ff_ppo import (
    await_params,
    check_ported,
    drain_episodes,
    make_evaluator,
    register_pipeline_board,
    resilience_counters,
    resilience_stats,
    sebulba_budget,
    sebulba_devices,
    shard_mean,
    shut_down,
    start_actors,
    supervised_actor,
    synchronize,
)
from stoix_tpu_torch.systems.q_learning.q_family import act_dist, build_q_network, make_q_apply
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.logger import LogEvent, StoixLogger
from stoix_tpu_torch.utils.timing import TimingTracker
from stoix_tpu_torch.utils.training import (
    ClipAdam, apply_updates, incremental_update, make_learning_rate,
)
from stoix_tpu_torch.utils.tree import tree_map, tree_merge_leading_dims, tree_stack

# Stats of the most recent run_experiment call in this process: learn steps,
# steady env-steps/s and fps, the timings, the replay ledger's deltas and
# the resilience block.
LAST_RUN_STATS = RunStats()


class DQNLearnerState(NamedTuple):
    params: OnlineAndTarget  # on the first learner device
    opt_state: Any
    generator: Any  # torch.Generator on the first learner device: the draws' uniforms


# ---------------------------------------------------------------- the learn step


class DQNLearnStep:
    """`step(state, replay_states, uniforms=None) -> (state, replay_states,
    metrics)`: one Sebulba DQN update over the service's shards (the JAX
    package's `get_dqn_learn_step`). `uniforms[epoch]` [B] replaces the
    epoch's draw from the learner's generator."""

    def __init__(self, q_apply: Callable, optim: ClipAdam, config: Any,
                 service: ShardedReplayService):
        self.q_apply, self.optim = q_apply, optim
        self.core = service.core
        self.devices = list(service.devices)
        system = config.system
        replay_cfg = dict(system.get("replay") or {})
        self.gamma = float(system.gamma)
        self.tau = float(system.tau)
        self.epochs = int(system.epochs)
        self.prioritized = bool(replay_cfg.get("prioritized", False))
        self.beta = float(replay_cfg.get("importance_beta", 0.4))
        self.guard_mode = guards.resolve_mode(config)

    def weights(self, replay_states: Sequence[Any], drawn: Sequence[Any]) -> List[torch.Tensor]:
        """Each shard's importance weights: `(N p)^-beta` from the GLOBAL
        probabilities (N the items held over all shards), 0 for a row drawn
        with p = 0, over the max over the shards; 1 without priorities."""
        if not self.prioritized:
            return [torch.ones_like(d.probabilities) for d in drawn]
        held = float(max(sum(self.core.occupancy(replay_states)), 1))
        raw = [torch.where(d.probabilities > 0,
                           pow_f32(held * torch.clamp_min(d.probabilities, 1e-9), -self.beta),
                           0.0) for d in drawn]
        home = self.devices[0]
        top = torch.max(torch.stack([torch.max(w).to(home) for w in raw]))
        return [w / torch.clamp_min(top.to(w.device), 1e-9) for w in raw]

    def shard_loss(self, params: OnlineAndTarget, batch: Transition, weights: torch.Tensor):
        """One shard's gradients of `0.5 mean(w td^2)` with respect to the
        online params, its loss, td and mean Q."""
        with torch.enable_grad():
            online = {k: v.detach().requires_grad_(True) for k, v in params.online.items()}
            q_tm1 = self.q_apply(online, batch.obs, 0.0).preferences
            with torch.no_grad():
                q_t = self.q_apply(params.target, batch.next_obs, 0.0).preferences
            d_t = self.gamma * (1.0 - batch.done.to(torch.float32))
            target = batch.reward + d_t * torch.amax(q_t, dim=-1)
            qa = torch.gather(q_tm1, -1, batch.action.long()[:, None])[:, 0]
            td = target.detach() - qa
            loss = 0.5 * torch.mean(weights * torch.square(td))
            grads = dict(zip(online, torch.autograd.grad(loss, list(online.values()))))
        return grads, loss.detach(), td.detach(), torch.mean(q_tm1.detach())

    @annotate("dqn_epoch")
    def epoch(self, params: OnlineAndTarget, opt_state: Any, replay_states: List[Any],
              uniforms: torch.Tensor):
        home = self.devices[0]
        drawn = self.core.sample_from_uniforms(replay_states, uniforms)
        weights = self.weights(replay_states, drawn)
        per_shard = [self.shard_loss(place(params, d), sample.experience, w)
                     for sample, w, d in zip(drawn, weights, self.devices)]
        grads = shard_mean([p[0] for p in per_shard], home)  # ROADMAP C26
        loss, mean_q = shard_mean([(p[1], p[3]) for p in per_shard], home)
        updates, new_opt = self.optim.update(grads, opt_state)
        online = apply_updates(params.online, updates)
        new = (OnlineAndTarget(online, incremental_update(online, params.target, self.tau)),
               new_opt)
        metrics = {"q_loss": loss, "mean_q": mean_q}
        if self.guard_mode != "off":
            new, guard_metrics = guards.guard_update(self.guard_mode, new=new,
                                                     old=(params, opt_state), loss=loss,
                                                     grads=(grads,))
            metrics.update(guard_metrics)
        if self.prioritized:
            replay_states = self.core.set_priorities(
                replay_states, [d.indices for d in drawn], [torch.abs(p[2]) for p in per_shard])
        return new[0], new[1], replay_states, metrics

    def __call__(self, state: DQNLearnerState, replay_states: List[Any],
                 uniforms: Optional[Sequence[torch.Tensor]] = None):
        params, opt_state = state.params, state.opt_state
        batch = self.core.sample_batch_size
        per_epoch = []
        for e in range(self.epochs):
            if uniforms is not None:
                u = uniforms[e].to(self.devices[0])
            else:
                u = torch.rand((batch,), generator=state.generator, device=self.devices[0])
            params, opt_state, replay_states, metrics = self.epoch(params, opt_state,
                                                                   replay_states, u)
            per_epoch.append(metrics)
        return (DQNLearnerState(params, opt_state, state.generator), replay_states,
                tree_stack(per_epoch))


def get_dqn_learn_step(q_apply: Callable, optim: ClipAdam, config: Any,
                       service: ShardedReplayService) -> DQNLearnStep:
    return DQNLearnStep(q_apply, optim, config, service)


# ---------------------------------------------------------------- the learner


class DQNSetup(NamedTuple):
    """What `learner_setup` builds."""

    state: DQNLearnerState
    learn_step: DQNLearnStep
    service: ShardedReplayService
    thread_apply_fn: Callable[[torch.device], Callable]
    eval_seed: int


def replay_item(env: Any) -> Transition:
    """One unbatched transition of the env's shapes (int32 action, float32
    reward, bool done), as the JAX package's service prototype."""
    obs = tree_map(lambda x: x.cpu(), env.observation_value())
    return Transition(obs=obs, action=torch.zeros((), dtype=torch.int32),
                      reward=torch.zeros((), dtype=torch.float32),
                      done=torch.zeros((), dtype=torch.bool),
                      next_obs=tree_map(lambda x: x.clone(), obs), info={})


def learner_setup(config: Any, env: Any, learner_devices: Sequence[torch.device]) -> DQNSetup:
    """The Q-network (built on the CPU from the run seed's first child seed,
    moved to the first learner device), clip + Adam, the replay service over
    the learner devices (refused unless `replay.impl` is sharded), the
    learn step and the learner's generator. `env` sizes the network."""
    init_seed, learn_seed, eval_seed = anakin.make_seeds(int(config.arch.seed), 3)
    home = torch.device(learner_devices[0])
    network = build_q_network(env, config, anakin.make_generator(init_seed, torch.device("cpu")))
    network.to(home)
    optim = ClipAdam(make_learning_rate(float(config.system.q_lr), config,
                                        int(config.system.epochs)),
                     float(config.system.max_grad_norm), eps=1e-5)
    online = {k: v.detach() for k, v in network.named_parameters()}
    service = service_from_config(learner_devices, replay_item(env), config)
    if service is None:
        raise ValueError(
            "Sebulba ff_dqn ingests through the sharded replay service: set "
            "system.replay.impl=sharded (the local item buffer lives inside "
            "Anakin's jitted learner and has no ingestion seam)")
    state = DQNLearnerState(OnlineAndTarget(online, online), optim.init(online),
                            anakin.make_generator(learn_seed, home))
    learn_step = get_dqn_learn_step(make_q_apply(network), optim, config, service)

    def thread_apply_fn(device: torch.device) -> Callable:
        """`q_apply` over a thread's own copy of the network on `device`
        (`functional_call` swaps a module's parameters while it runs)."""
        return make_q_apply(copy.deepcopy(network).to(device))

    return DQNSetup(state, learn_step, service, thread_apply_fn, eval_seed)


# ---------------------------------------------------------------- the actor


def rollout_thread(actor_id: int, actor_device: torch.device, env_factory: Any,
                   apply_fn: Callable[[torch.device], Callable], config: Any,
                   pipeline: OffPolicyPipeline, param_server: ParameterServer,
                   learner_devices: Sequence[torch.device], lifetime: ThreadLifetime,
                   seed: int, metrics_sink: "queue.Queue", supervisor: Any = None) -> None:
    supervised_actor(_rollout_body, actor_id, lifetime, supervisor, actor_id, actor_device,
                     env_factory, apply_fn, config, pipeline, param_server, learner_devices,
                     lifetime, seed, metrics_sink)


def _rollout_body(actor_id, actor_device, env_factory, apply_fn, config, pipeline,
                  param_server, learner_devices, lifetime, seed, metrics_sink):
    envs_per_actor = int(config.arch.actor.envs_per_actor)
    rollout_length = int(config.system.rollout_length)
    train_eps = float(config.system.training_epsilon)
    timer = TimingTracker()
    envs = env_factory(envs_per_actor)
    timestep = envs.reset(seed=seed)
    generator = anakin.make_generator(seed, actor_device)
    q_apply = apply_fn(actor_device)

    @torch.no_grad()
    def act(params, observation):
        return act_dist(q_apply(params, observation, train_eps)).sample(generator)

    params = await_params(param_server, actor_id, lifetime)
    if params is None:
        return
    n_learners = len(learner_devices)
    rollout_idx = 0
    while not lifetime.should_stop():
        faultinject.maybe_crash_actor(actor_id, rollout_idx)
        faultinject.maybe_stall_queue(actor_id, rollout_idx, should_abort=lifetime.should_stop)
        if rollout_idx > 0:
            # Off-policy actors never wait for params: the freshest queued
            # version when there is one, else the current one.
            try:
                fetched = param_server.get_params(actor_id, timeout=0.0)
                if fetched is None:
                    break
                params = fetched
            except queue.Empty:
                pass
        traj: List[Transition] = []
        infos = []
        with span("actor_rollout", actor=actor_id, idx=rollout_idx), timer.time("rollout"):
            for _ in range(rollout_length):
                with timer.time("inference"):
                    obs_local = place(timestep.observation, actor_device)
                    action = act(params, obs_local)
                with timer.time("env_step"):
                    next_timestep = envs.step(action)
                # Episode metrics travel through metrics_sink, not the ring;
                # actions as the ring holds them (int32, as JAX's draws).
                traj.append(place(Transition(
                    obs=obs_local, action=action.to(torch.int32), reward=next_timestep.reward,
                    done=next_timestep.discount == 0.0,
                    next_obs=next_timestep.extras["next_obs"], info={}), actor_device))
                infos.append(next_timestep.extras["episode_metrics"])
                timestep = next_timestep

        with span("actor_prepare_data", actor=actor_id), timer.time("prepare_data"):
            # [T, E] -> T.E transitions -> one piece a learner device, on it.
            flat = tree_merge_leading_dims(tree_stack(traj), 2)
            payload = [tree_map(lambda x, i=i, d=d: x.chunk(n_learners, dim=0)[i].to(d), flat)
                       for i, d in enumerate(learner_devices)]
        with timer.time("queue_put"):
            try:
                pipeline.push(actor_id, payload, timeout=PUT_TIMEOUT_S)
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


def refuse_ignored_layers(config: Any) -> None:
    """`arch.preflight`, `arch.integrity` and `arch.fleet`, which the JAX
    Sebulba ff_dqn never reads (its runner wires the goodput ledger, the
    flight recorder, the ops plane and preemption only, and records
    `"fleet": False`), raise, naming the key, rather than be ignored."""
    ignored = [f"arch.{block}.enabled" for block in ("preflight", "integrity", "fleet")
               if (config.arch.get(block) or {}).get("enabled", False)]
    if ignored:
        raise NotImplementedError(
            f"not ported for Sebulba ff_dqn (the JAX package's ignores it): {', '.join(ignored)}")


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    """Train Sebulba DQN; returns the last evaluation's mean return. The
    roles' devices are cards unless the caller asks for the CPU."""
    LAST_RUN_STATS.clear()
    check_ported(config)
    refuse_ignored_layers(config)
    guard_mode = guards.resolve_mode(config)
    roles = MeshRoles.from_config(config, devices=sebulba_devices(config, device))
    actor_devices = roles.role_devices("act")
    learner_devices = roles.role_devices("learn")
    evaluator_device = roles.device("evaluate")

    actors_per_device = int(config.arch.actor.actor_per_device)
    num_actors = len(actor_devices) * actors_per_device
    chunk = (int(config.arch.total_num_envs) // num_actors) * int(config.system.rollout_length)
    if chunk % len(learner_devices) != 0:
        raise ValueError(
            f"envs_per_actor * rollout_length ({chunk}) must divide over "
            f"{len(learner_devices)} learner device(s) for shard-wise ingestion")
    sebulba_budget(config, num_actors)

    env_factory = make_factory(config)
    probe_envs = env_factory(1)
    config.system.action_dim = probe_envs.num_actions
    setup = learner_setup(config, probe_envs, learner_devices)
    state, learn_step, service = setup.state, setup.learn_step, setup.service
    replay_base = service.stats()
    eval_q_apply = setup.thread_apply_fn(evaluator_device)
    eval_eps = float(config.system.evaluation_epsilon)
    eval_fn = make_evaluator(config, lambda p, observation: act_dist(
        eval_q_apply(p, observation, eval_eps)), env_factory, evaluator_device)
    eval_generator = anakin.make_generator(setup.eval_seed, evaluator_device)

    logger = StoixLogger(config)
    log_lock = threading.Lock()

    def log(metrics, t, t_eval, event):
        with log_lock:
            logger.log(metrics, t, t_eval, event)

    # This run's goodput ledger and flight-recorder identity, as the JAX runner.
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
    pipeline = OffPolicyPipeline(num_actors)
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
    param_server.distribute_params(state.params.online)

    supervisor = supervisor_from_config(config, lifetime, pipeline, param_server)

    def make_thread(actor_id: int, actor_device) -> threading.Thread:
        return threading.Thread(
            target=rollout_thread,
            args=(actor_id, actor_device, env_factory, setup.thread_apply_fn, config, pipeline,
                  param_server, learner_devices, lifetime,
                  int(config.arch.seed) + 7919 * actor_id, metrics_sink, supervisor),
            name=f"actor-{actor_id}", daemon=True)

    actor_threads = start_actors(make_thread, actor_devices, actors_per_device, supervisor,
                                 pipeline.heartbeats)

    def ingest(payloads) -> None:
        for _actor_id, payload in payloads:
            service.add(payload)

    def ingested_items() -> int:
        return service.stats()["added_items"] - replay_base["added_items"]

    timer = TimingTracker()
    param_sync = max(1, int(dict(config.system.get("replay") or {}).get(
        "param_sync_interval", 1)))
    epochs = int(config.system.epochs)
    learn_steps = 0
    timings: Dict[str, float] = {}
    pending_returns: List[float] = []
    skipped_base = guards.skipped_counter().value()
    steady_start_time = None  # set after the first eval window (post-compile)
    steady_start_items = 0
    run_start_time = time.perf_counter()
    steady_end_time = run_start_time
    replay_warmed = False
    preempt = PreemptionHandler().install()
    preempted = False
    try:
        for update_idx in range(int(config.arch.num_updates)):
            with timer.time("ingest"):
                ingest(pipeline.poll(timeout=0.0))
                # The fill only grows, so the blocking wait ends for good
                # once the service can sample.
                while not replay_warmed and not service.can_sample():
                    ingest(pipeline.wait_for_data())
                replay_warmed = True
            with span("learner_update", update=update_idx), timer.time("learn"):
                state, new_replay, train_metrics = learn_step(state, service.state)
                service.commit(new_replay)
                service.note_embedded_samples(epochs)
                synchronize(learner_devices)
            learn_steps += 1
            if (update_idx + 1) % param_sync == 0:
                param_server.distribute_params(state.params.online)
            t_steps = ingested_items()
            guards.publish_guard_metrics(guard_mode, train_metrics, t_steps)
            ledger.note(goodput.SEBULBA_PHASE_MAP["ingest"], timer.latest("ingest"))
            ledger.note(goodput.SEBULBA_PHASE_MAP["learn"], timer.latest("learn"))
            # Drained every update: the sink is unbounded.
            pending_returns.extend(drain_episodes(metrics_sink, timings))
            if preempt.stop_requested():
                preempt.acknowledge(t_steps)
                preempted = True
                break

            if (update_idx + 1) % int(config.arch.num_updates_per_eval) == 0:
                if pending_returns:
                    log({"episode_return": np.asarray(pending_returns)}, t_steps, update_idx,
                        LogEvent.ACT)
                    pending_returns = []
                log({k: v.mean() for k, v in train_metrics.items()}, t_steps, update_idx,
                    LogEvent.TRAIN)
                timings.update({**timer.all_means(prefix="learner_"),
                                **timer.all_percentiles(prefix="learner_")})
                log({**timings, **{f"replay_{k}": v for k, v in service.observe().items()
                                   if not isinstance(v, list)}},
                    t_steps, update_idx, LogEvent.MISC)
                async_evaluator.submit(place(state.params.online, evaluator_device),
                                       eval_generator, t_steps)
                if steady_start_time is None:
                    steady_start_time = time.perf_counter()
                    steady_start_items = ingested_items()
                status.update({"window": (update_idx + 1) // int(config.arch.num_updates_per_eval),
                               "step": t_steps})
                recorder.record("window",
                                window=(update_idx + 1) // int(config.arch.num_updates_per_eval),
                                step=t_steps, updates=update_idx + 1,
                                ingest_s=round(timer.mean("ingest"), 6),
                                learn_s=round(timer.mean("learn"), 6))
        # Close the window BEFORE shutdown: joins and the evaluator's drain
        # must not deflate the steady-state number.
        steady_end_time = time.perf_counter()
    finally:
        preempt.uninstall()
        goodput.set_active(None)
        monitor.unregister("sebulba-pipeline")
        shut_down(lifetime, param_server, pipeline, supervisor, actor_threads, async_evaluator)
        logger.close()

    final_items = ingested_items()
    if steady_start_time is not None and final_items > steady_start_items:
        steady = (final_items - steady_start_items) / (steady_end_time - steady_start_time)
        registry.gauge("stoix_tpu_sebulba_steps_per_sec_steady",
                       "Post-compile steady-state env-steps/sec of the most recent run").set(steady)
        LAST_RUN_STATS["steps_per_sec_steady"] = steady
    if final_items > 0:
        LAST_RUN_STATS["fps"] = final_items / max(steady_end_time - run_start_time, 1e-9)
        LAST_RUN_STATS["total_env_steps"] = final_items
    replay_stats = service.stats()
    LAST_RUN_STATS.update({
        "learn_steps": learn_steps,
        "num_actors": num_actors,
        "envs_per_actor": int(config.arch.actor.envs_per_actor),
        "timings": timings,
        "eval_returns": list(eval_results),
        "history": logger.history,
        "replay": {k: replay_stats[k] - replay_base[k] for k in replay_stats},
        "ring_bytes": service.ring_bytes(),
        "resilience": resilience_stats(guard_mode, skipped_base, supervisor, counters,
                                       counter_base, preempted),
        "goodput": ledger.finalize(),
    })
    return eval_results[-1] if eval_results else 0.0


def main() -> float:
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/sebulba/default_ff_dqn.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
