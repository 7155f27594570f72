#!/usr/bin/env python3
"""B1 (the linear recurrence and, since the redesign, its one-launch GAE)
against an earlier version, on one CUDA card, in turns: old, new, new, old.

    python3 scripts/torch_ab_linear_recurrence.py --old DIR [--updates N] [--reps N] \
        [--out PATH]

DIR holds the earlier version's four files, side by side:
`linear_recurrence.cu` (from stoix_tpu_torch/csrc/), `linear_recurrence.py`
(kernels/), `scan_kernels.py` and `multistep.py` (ops/), for example

    mkdir -p results/old && for f in csrc/linear_recurrence.cu \\
        kernels/linear_recurrence.py ops/scan_kernels.py ops/multistep.py; do
      git show <commit>:stoix_tpu_torch/$f > results/old/$(basename $f); done

in a git-ignored directory of the checkout (`results/`). The old source is
built here with the port's nvcc flags beside the current one, and the old
modules are loaded from DIR, wired to each other and to that library: the old GAE is the old composed path (separate
elementwise ops around the old wrapper and kernel). Both versions are checked
against the CPU's `scan` GAE (bitwise) before anything is timed. Then, in
turns:

  * the generic recurrence at [16, 1024] and [128, 4096] float32: device ms a
    launch replayed from a CUDA graph, ms a call from Python (CUDA events),
    and the new library's empty kernel on the new grid (the launch floor);
  * the GAE phase of one ff_ppo and one ff_trans_ppo update at their default
    configs (1024 envs, T = 16), on one fixed rollout: the bootstrap critic
    pass and GAE (as `PPOLearner.update` forms it) each on the host clock
    (median of --reps, each ended by a device synchronize), and GAE once
    under torch.profiler for its device time and its device launches (kernels,
    copies and fills);
  * --updates ff_ppo update steps (default 4, after two of warm-up) on the
    host clock, the learner's GAE through one version: env-steps/s.

Prints ptxas's report for both libraries, one JSON object, and writes it to
--out (default results/ab_linear_recurrence.json).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import statistics
import sys
import time
from functools import partial

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke  # noqa: E402
from stoix_tpu_torch import envs  # noqa: E402
from stoix_tpu_torch.kernels import build  # noqa: E402
from stoix_tpu_torch.kernels import linear_recurrence as lr  # noqa: E402
from stoix_tpu_torch.ops import multistep, scan_kernels  # noqa: E402
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo, ff_trans_ppo  # noqa: E402
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps  # noqa: E402
from torch_profile_ppo import _union_us, critic_pass, gae  # noqa: E402

TURNS = ("old", "new", "new", "old")
SHAPES = ((16, 1024), (128, 4096))
SYSTEMS = {"ff_ppo": (ff_ppo, "default/anakin/default_ff_ppo.yaml"),
           "ff_trans_ppo": (ff_trans_ppo, chip_smoke.TRANS_ROOT)}


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def old_version(directory: str) -> dict:
    """The earlier wrapper, dispatch and GAE, wired to the earlier source."""
    wrapper = _load("old_linear_recurrence", os.path.join(directory, "linear_recurrence.py"))
    wrapper.LIBRARY = build.CudaLibrary(
        os.path.abspath(os.path.join(directory, "linear_recurrence.cu")),
        wrapper.LIBRARY.entries, wrapper.LIBRARY.error_entry)
    dispatch = _load("old_scan_kernels", os.path.join(directory, "scan_kernels.py"))
    dispatch.linear_recurrence = wrapper
    estimators = _load("old_multistep", os.path.join(directory, "multistep.py"))
    estimators.scan_kernels = dispatch
    return {"library": wrapper.LIBRARY, "kernel": wrapper.KERNEL,
            "gae": estimators.truncated_generalized_advantage_estimation}


def check(versions) -> None:
    """Both GAEs on the card against `scan` on the CPU, bitwise."""
    cpu = [x.cpu() for x in chip_smoke.gae_inputs(16, 1024, seed=70)]
    want = multistep.truncated_generalized_advantage_estimation(
        cpu[0], cpu[1], 0.95, v_tm1=cpu[2], v_t=cpu[3], truncation_t=cpu[4], impl="scan")
    card = [x.cuda() for x in cpu]
    for name, version in versions.items():
        got = version["gae"](card[0], card[1], 0.95, v_tm1=card[2], v_t=card[3],
                             truncation_t=card[4], impl="pallas")
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"the {name} GAE != the CPU scan")
        for t_len, batch in SHAPES:
            w, d, init = chip_smoke.recurrence_inputs(t_len, batch, torch.float32, True, seed=71)
            if not torch.equal(version["kernel"](w, d, init),
                               lr.plain_linear_recurrence_reverse(w, d, init)):
                raise AssertionError(f"the {name} kernel != plain at [{t_len}, {batch}]")


def kernel_turns(versions) -> list:
    inputs = {shape: chip_smoke.recurrence_inputs(*shape, torch.float32, False, seed=72)
              for shape in SHAPES}
    turns = []
    for name in TURNS:
        times = {}
        for (t_len, batch), (w, d, init) in inputs.items():
            run = partial(versions[name]["kernel"], w, d, init)
            times[f"[{t_len}, {batch}]"] = {"device_ms": chip_smoke.graph_ms(run),
                                            "ms": chip_smoke.cuda_ms(run)}
            if name == "new":
                times[f"[{t_len}, {batch}]"]["empty_kernel_device_ms"] = chip_smoke.graph_ms(
                    chip_smoke.launch_floor(t_len, batch))
        turns.append({"version": name, "times": times})
    return turns


def _learner(system: str):
    module, root = SYSTEMS[system]
    config = chip_smoke.compose(["system.multistep_impl=pallas", "arch.num_updates=100",
                                 "arch.num_evaluation=1"], root)
    scan_kernels.configure_from_config(config)
    config = check_total_timesteps(config, 1)
    env, _ = envs.make(config)
    setup = module.learner_setup(env, config, torch.device("cuda"), seed=int(config.arch.seed))
    return setup.learn, setup.learner_state, config


def _host_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def _profiled(fn) -> dict:
    """Device time (the union of intervals) and device launches of one call."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"device_us": _union_us([(e.time_range.start, e.time_range.end) for e in events]),
            "device_launches": len(events),
            "kernels": sorted({e.name[:60] for e in events})}


def gae_phase_turns(versions, reps: int) -> dict:
    """The bootstrap critic pass and GAE of one update, in turns, per system."""
    out = {}
    for system in SYSTEMS:
        learner, state, _ = _learner(system)
        state, traj = learner.rollout(state)
        v_t = critic_pass(learner, state.params, traj)
        turns = []
        for name in ("warm-up",) + TURNS:
            version = versions["new" if name == "warm-up" else name]
            run_gae = partial(gae, learner, traj, v_t, version["gae"])
            run_critic = partial(critic_pass, learner, state.params, traj)
            critic_ms, gae_ms = _host_ms(run_critic, reps), _host_ms(run_gae, reps)
            if name == "warm-up":
                continue
            turns.append({"version": name, "critic_host_ms": critic_ms, "gae_host_ms": gae_ms,
                          "gae": _profiled(run_gae), "critic": _profiled(run_critic)})
        out[system] = turns
    return out


@contextlib.contextmanager
def learner_gae(estimator):
    """ff_ppo's learner (and so ff_trans_ppo's) calls GAE through `estimator`."""
    original = ff_ppo.truncated_generalized_advantage_estimation
    ff_ppo.truncated_generalized_advantage_estimation = estimator
    try:
        yield
    finally:
        ff_ppo.truncated_generalized_advantage_estimation = original


def update_turns(versions, updates: int) -> dict:
    learner, state, config = _learner("ff_ppo")
    turns = []
    for name in ("warm-up",) + TURNS:
        with learner_gae(versions["new" if name == "warm-up" else name]["gae"]):
            times = []
            for _ in range(2 if name == "warm-up" else updates):
                torch.cuda.synchronize()
                start = time.perf_counter()
                state, _ = learner.update_step(state)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - start) * 1e3)
        if name != "warm-up":
            turns.append({"version": name, "update_step_ms": times})
    steps = int(config.system.rollout_length) * int(config.arch.total_num_envs)
    mean = {name: statistics.mean(ms for t in turns if t["version"] == name
                                  for ms in t["update_step_ms"]) for name in ("old", "new")}
    return {"env_steps_per_update": steps, "turns": turns, "mean_update_step_ms": mean,
            "env_steps_per_second": {name: steps / (ms / 1e3) for name, ms in mean.items()}}


def _mean(turns, name, pick) -> float:
    return statistics.mean(pick(t) for t in turns if t["version"] == name)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old", required=True, help="directory of the earlier four files")
    parser.add_argument("--updates", type=int, default=4)
    parser.add_argument("--reps", type=int, default=21)
    parser.add_argument("--out", default="results/ab_linear_recurrence.json")
    args = parser.parse_args()
    smi = chip_smoke.phase_device()
    versions = {"new": {"library": lr.LIBRARY, "kernel": lr.KERNEL,
                        "gae": multistep.truncated_generalized_advantage_estimation},
                "old": old_version(args.old)}
    build.build_all([v["library"] for v in versions.values()])
    ptxas = {name: chip_smoke.ptxas_instances(v["library"].ptxas_report())
             for name, v in versions.items()}
    check(versions)
    kernels = kernel_turns(versions)
    mean = {name: {shape: _mean(kernels, name, lambda t, s=shape: t["times"][s]["device_ms"])
                   for shape in kernels[0]["times"]} for name in versions}
    phases = gae_phase_turns(versions, args.reps)
    phase_mean = {
        system: {name: {key: _mean(turns, name, pick) for key, pick in (
            ("critic_host_ms", lambda t: t["critic_host_ms"]),
            ("gae_host_ms", lambda t: t["gae_host_ms"]),
            ("gae_device_us", lambda t: t["gae"]["device_us"]),
            ("gae_device_launches", lambda t: t["gae"]["device_launches"]),
            ("critic_device_us", lambda t: t["critic"]["device_us"]))}
            for name in versions}
        for system, turns in phases.items()}
    report = {
        "card": smi, "old": args.old, "ptxas": ptxas,
        "kernel_turns": kernels, "mean_device_ms": mean,
        "speedup_device": {s: mean["old"][s] / mean["new"][s] for s in mean["new"]},
        "gae_phase_turns": phases, "gae_phase_mean": phase_mean,
        "ff_ppo_updates": update_turns(versions, args.updates),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
