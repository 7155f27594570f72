#!/usr/bin/env python3
"""Where the time of one Anakin PPO update step goes in the PyTorch port, on
one CUDA card, at the default config's full width: ff_ppo (the default),
ff_trans_ppo, ff_ppo_continuous or rec_ppo.

    python3 scripts/torch_profile_ppo.py [--system ff_trans_ppo] [--updates N] [--out PATH] \
        [overrides ...]

Builds the learner exactly as `run_experiment` does (system.multistep_impl=
pallas unless overridden), warms it up with two update steps, then:

  * host clock, each phase ended by a device synchronize: rollout, the
    bootstrap critic pass, GAE (as `PPOLearner.update` forms it: the discounts,
    the reward scale, the truncation cast and the estimator), and the update
    (bootstrap, GAE and the epochs x minibatches of updates); rec_ppo reads
    its bootstrap values in the rollout, so its critic phase is empty;
  * torch.profiler over N whole update steps: the device busy time (the union
    of kernel and copy intervals), kernel launches per update, and the kernels
    that take the most device time, B1 and B2 (flash attention) included.
    The profiler slows the host many times over, so the busy share is taken
    against the UNPROFILED wall time of an update (rollout + update phases
    above).

Prints one JSON object and writes it to --out (default
results/torch_profile_ppo.json).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stoix_tpu_torch import envs  # noqa: E402
from stoix_tpu_torch.kernels import flash_attention, linear_recurrence  # noqa: E402
from stoix_tpu_torch.ops import scan_kernels, truncated_generalized_advantage_estimation  # noqa: E402
from stoix_tpu_torch.systems.ppo.anakin import (  # noqa: E402
    ff_ppo, ff_ppo_continuous, ff_trans_ppo, rec_ppo,
)

SYSTEMS = {"ff_ppo": ff_ppo, "ff_trans_ppo": ff_trans_ppo,
           "ff_ppo_continuous": ff_ppo_continuous, "rec_ppo": rec_ppo}
from stoix_tpu_torch.utils import config as config_lib  # noqa: E402
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps  # noqa: E402


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def critic_pass(learner, params, traj):
    """The learner's bootstrap critic pass, as `PPOLearner.update` runs it
    (rec_ppo's values, read step by step in its rollout, as they are)."""
    if isinstance(learner, rec_ppo.RecPPOLearner):
        return traj.bootstrap_value
    with torch.no_grad():
        return learner.critic_apply(params.critic_params, learner.bootstrap_input(traj))


def gae(learner, traj, v_t, estimator=truncated_generalized_advantage_estimation):
    """The learner's GAE, as `PPOLearner.update` forms it, through `estimator`."""
    with torch.no_grad():
        return estimator(
            traj.reward * learner.reward_scale, learner.gamma * (1.0 - traj.done.to(torch.float32)),
            learner.gae_lambda, v_tm1=traj.value, v_t=v_t,
            truncation_t=traj.truncated.to(torch.float32),
            standardize_advantages=learner.standardize_advantages, impl=learner.multistep_impl,
        )


def _phases(learner, state, sync):
    """One update step split into host-timed phases."""
    t0 = time.perf_counter()
    state, traj = learner.rollout(state)
    sync()
    t1 = time.perf_counter()
    v_t = critic_pass(learner, state.params, traj)
    sync()
    t2 = time.perf_counter()
    gae(learner, traj, v_t)
    sync()
    t3 = time.perf_counter()
    result = learner.update(state.params, state.opt_states, traj, state.generator)
    sync()
    t4 = time.perf_counter()
    state = state._replace(params=result.params, opt_states=result.opt_states)
    return state, {"rollout_ms": (t1 - t0) * 1e3, "critic_ms": (t2 - t1) * 1e3,
                   "gae_ms": (t3 - t2) * 1e3, "update_ms_including_gae": (t4 - t3) * 1e3}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--system", choices=sorted(SYSTEMS), default="ff_ppo")
    parser.add_argument("--updates", type=int, default=3)
    parser.add_argument("--out", default="results/torch_profile_ppo.json")
    args, overrides = parser.parse_known_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    sync = torch.cuda.synchronize

    system = SYSTEMS[args.system]
    config = config_lib.compose(
        config_lib.default_config_dir(), f"default/anakin/default_{args.system}.yaml",
        ["system.multistep_impl=pallas", "arch.num_updates=100", "arch.num_evaluation=1",
         *overrides],
    )
    scan_kernels.configure_from_config(config)
    config = check_total_timesteps(config, 1)
    env, _ = envs.make(config)
    setup = system.learner_setup(env, config, device, seed=int(config.arch.seed))
    learner, state = setup.learn, setup.learner_state
    for _ in range(2):  # warm-up: cuBLAS handles, kernel build, allocator
        state, _ = learner.update_step(state)
    sync()

    phases = []
    for _ in range(args.updates):
        state, phase = _phases(learner, state, sync)
        phases.append(phase)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    counters = (*linear_recurrence.COUNTERS, *flash_attention.COUNTERS)
    for counter in counters:
        counter.launches = 0
    sync()
    start = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(args.updates):
            state, _ = learner.update_step(state)
        sync()
    wall_us = (time.perf_counter() - start) * 1e6

    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in device_events:
        entry = by_name.setdefault(e.name, [0, 0.0])
        entry[0] += 1
        entry[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in device_events])
    ours = {k: v for k, v in by_name.items() if "recurrence" in k or "flash_" in k}
    steps_per_update = int(config.system.rollout_length) * int(config.arch.total_num_envs)
    unprofiled_ms = sum(
        p["rollout_ms"] + p["update_ms_including_gae"] for p in phases
    ) / len(phases)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    report = {
        "card": smi,
        "torch": torch.__version__,
        "system": args.system,
        "config": {"total_num_envs": int(config.arch.total_num_envs),
                   "rollout_length": int(config.system.rollout_length),
                   "epochs": int(config.system.epochs),
                   "num_minibatches": int(config.system.num_minibatches),
                   "multistep_impl": str(config.system.multistep_impl)},
        "updates_profiled": args.updates,
        "host_phases_ms": phases,
        "profiled_wall_ms_per_update": wall_us / args.updates / 1e3,
        "env_steps_per_second_profiled": steps_per_update * args.updates / (wall_us / 1e6),
        "device_events": len(device_events),
        "device_busy_ms_per_update": busy_us / args.updates / 1e3,
        "unprofiled_wall_ms_per_update": unprofiled_ms,
        "env_steps_per_second_unprofiled": steps_per_update / (unprofiled_ms / 1e3),
        "device_busy_share_of_unprofiled_wall": (
            busy_us / args.updates / 1e3 / unprofiled_ms if device_events else "not measured"),
        "device_launches_per_update": len(device_events) / args.updates,
        "kernel_launches": {c.name: c.launches for c in counters},
        "kernel_device_us_per_launch": (
            {k[:90]: v[1] / v[0] for k, v in ours.items()} if ours else "not measured"),
        "kernel_device_us_per_update": (
            {k[:90]: v[1] / args.updates for k, v in ours.items()} if ours else "not measured"),
        "top_device_time": [{"name": k[:90], "count_per_update": v[0] / args.updates,
                             "us_per_update": v[1] / args.updates} for k, v in top],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
