#!/usr/bin/env python3
"""B2's forward kernel and B3 (the chunk kernel), on the forward core they
share, and B2's backward kernel, against an earlier version of the same
sources, on one CUDA card, in turns: old, new, new, old.

    python3 scripts/torch_ab_flash_forward.py --old-source PATH --old-chunk-source PATH \
        [--updates N] [--out PATH]

The two paths are copies of the earlier `stoix_tpu_torch/csrc/flash_attention.cu`
and `stoix_tpu_torch/csrc/flash_attention_chunk.cu` (for example `git show
<commit>:stoix_tpu_torch/csrc/flash_attention.cu` into a git-ignored directory
of the checkout, such as `results/`), or of a variant of the current sources
(copied with `flash_forward.cuh` beside them, one constant changed; a copy of
a version that has the core includes that version's `flash_forward.cuh` from
beside it). They are built here with the port's nvcc flags beside the current
sources. Both versions are checked against the plain versions (1e-5: the
forward and backward absolute, B3 relative to l) before anything is timed.
Then, in turns, per launch replayed from a CUDA graph (device ms) and per
call from Python (CUDA events):

  * the forward at ff_trans_ppo's three path shapes [1024 | 4096 | 16384, 16,
    4, 32] and at [64, 512, 4, 32], float32 causal, from strided views of one
    fused projection;
  * the backward at ff_trans_ppo's minibatch shape [4096, 16, 4, 32];
  * B3 at the one-rank ring's chunk [64, 512, 4, 32] and at the visible,
    diagonal and future chunks [64, 128, 4, 32] of a 4-rank causal ring;
  * the full-width ring torso forward over a window of 512 through a one-rank
    NCCL ring (B3), and the same torso through B2's forward;
  * Anakin ff_trans_ppo's learner at its default config
    (`system.multistep_impl=pallas`), every attention forward and backward
    through one version: N update steps a turn
    (default 3, after two of warm-up) on the host clock, each ended by a
    device synchronize, and one more under torch.profiler for the device busy
    time of an update.

Prints ptxas's registers and spills for every library, one JSON object, and
writes it to --out (default results/ab_flash_forward.json).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from functools import partial

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke  # noqa: E402
from stoix_tpu_torch import envs, parallel  # noqa: E402
from stoix_tpu_torch.kernels import build  # noqa: E402
from stoix_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from stoix_tpu_torch.kernels import flash_attention_chunk as fac  # noqa: E402
from stoix_tpu_torch.networks.attention import TransformerTorso  # noqa: E402
from stoix_tpu_torch.ops import scan_kernels  # noqa: E402
from stoix_tpu_torch.ops.ring_attention import ring_attention  # noqa: E402
from stoix_tpu_torch.systems.ppo.anakin import ff_trans_ppo  # noqa: E402
from stoix_tpu_torch.utils import config as config_lib  # noqa: E402
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps  # noqa: E402
from torch_profile_ppo import _union_us  # noqa: E402

FORWARD_SHAPES = [(1024, 16, 4, 32), (4096, 16, 4, 32), (16384, 16, 4, 32), (64, 512, 4, 32)]
BACKWARD_SHAPE = (4096, 16, 4, 32)
WINDOW, LOCAL = 512, 128  # the ring's window; the 4-rank ring's chunk length
TURNS = ("old", "new", "new", "old")


def old_libraries(source: str, chunk_source: str):
    return {
        "forward": build.CudaLibrary(os.path.abspath(source), fa.LIBRARY.entries,
                                     fa.LIBRARY.error_entry),
        "chunk": build.CudaLibrary(os.path.abspath(chunk_source), fac.LIBRARY.entries,
                                   fac.LIBRARY.error_entry),
    }


@contextlib.contextmanager
def through(libraries):
    """Every B2 forward and backward and every B3 launch goes through these
    libraries."""
    forward, backward, chunk_library = fa.forward_kernel, fa.backward_kernel, fac.LIBRARY

    def in_library(kernel):
        def run(*args, **kwargs):
            current = fa.LIBRARY
            fa.LIBRARY = libraries["forward"]
            try:
                return kernel(*args, **kwargs)
            finally:
                fa.LIBRARY = current
        return run

    fa.forward_kernel, fa.backward_kernel = in_library(forward), in_library(backward)
    fac.LIBRARY = libraries["chunk"]
    try:
        yield
    finally:
        fa.forward_kernel, fa.backward_kernel, fac.LIBRARY = forward, backward, chunk_library


def chunk_cases(q, k, v, positions):
    cases = {"one-rank": (q, k, v, positions, positions)}
    for kind, src in (("visible", 0), ("diagonal", 1), ("future", 2)):
        rows, keys = slice(LOCAL, 2 * LOCAL), slice(src * LOCAL, (src + 1) * LOCAL)
        cases[kind] = (q[:, rows], k[:, keys], v[:, keys], positions[rows], positions[keys])
    return cases


def backward_inputs():
    q, k, v = chip_smoke.qkv_views(*BACKWARD_SHAPE, torch.float32, seed=52)
    dout = chip_smoke.qkv_views(*BACKWARD_SHAPE, torch.float32, seed=53)[0].contiguous()
    o, lse = fa.forward_kernel(q, k, v, True, need_lse=True)
    return q, k, v, o, lse, dout, True


def check(versions, forward_inputs, chunks) -> dict:
    """Both versions against the plain versions, before any timing."""
    errors = {}
    grads = backward_inputs()
    for name, libraries in versions.items():
        with through(libraries):
            got = fa.backward_kernel(*grads)
            want = fa.plain_flash_attention_backward(*grads)
            errors[f"{name} backward {list(BACKWARD_SHAPE)}"] = max(
                (g - w).abs().max().item() for g, w in zip(got, want))
            for shape, (q, k, v) in forward_inputs.items():
                got, lse = fa.forward_kernel(q, k, v, True, need_lse=True)
                want, want_lse = fa.plain_flash_attention_forward(q, k, v, True, need_lse=True)
                err = max((got - want).abs().max().item(), (lse - want_lse).abs().max().item())
                errors[f"{name} forward {list(shape)}"] = err
            for case, args in chunks.items():
                got = fac.chunk_kernel(*args, causal=True)
                err = max(fac.chunk_errors(got, fac.plain_flash_attention_chunk(*args, True)))
                errors[f"{name} chunk {case}"] = err
    if not max(errors.values()) <= 1e-5:
        raise AssertionError(f"a version disagrees with its plain version: {errors}")
    return errors


def kernel_turns(versions, forward_inputs, chunks) -> list:
    turns = []
    grads = backward_inputs()
    for name in TURNS:
        times = {}
        with through(versions[name]):
            run = partial(fa.backward_kernel, *grads)
            times[f"backward {list(BACKWARD_SHAPE)}"] = {"device_ms": chip_smoke.graph_ms(run),
                                                        "ms": chip_smoke.cuda_ms(run)}
            for shape, (q, k, v) in forward_inputs.items():
                run = partial(fa.forward_kernel, q, k, v, True)
                times[f"forward {list(shape)}"] = {"device_ms": chip_smoke.graph_ms(run),
                                                   "ms": chip_smoke.cuda_ms(run)}
            for case, args in chunks.items():
                run = partial(fac.chunk_kernel, *args, causal=True)
                times[f"chunk {case}"] = {"device_ms": chip_smoke.graph_ms(run),
                                          "ms": chip_smoke.cuda_ms(run)}
        turns.append({"version": name, "times": times})
    return turns


def ring_turns(versions) -> list:
    """The full-width torso's forward through a one-rank NCCL ring and through
    B2's forward, in turns; ms a forward."""
    width = chip_smoke.ring_width()
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        config = config_lib.Config.from_dict({"arch": {"distributed": {
            "coordinator_address": "file://" + os.path.join(tmp, "store"),
            "num_processes": 1, "process_id": 0,
        }}})
        parallel.maybe_initialize_distributed(config, device="cuda")
        try:
            group = parallel.create_mesh({"data": 1}, device="cuda").get_group("data")

            def torso(attention_fn=None):
                return TransformerTorso(
                    width["obs"], width["layers"], width["heads"], width["head_dim"],
                    width["ffn"], attention_fn=attention_fn,
                    generator=torch.Generator().manual_seed(0),
                ).cuda()

            ring_torso = torso(partial(ring_attention, group=group))
            flash_torso = torso()
            x = torch.randn((chip_smoke.RING_BATCH, width["window"], width["obs"]),
                            generator=torch.Generator().manual_seed(1)).cuda()
            timed = partial(chip_smoke.cuda_ms, repeats=7, inner=5)
            for name in TURNS:
                with through(versions[name]), torch.no_grad():
                    turns.append({"version": name,
                                  "ring_torso_forward_ms": timed(lambda: ring_torso(x)),
                                  "flash_torso_forward_ms": timed(lambda: flash_torso(x))})
        finally:
            dist.destroy_process_group()
    return turns


def update_turns(versions, updates: int) -> dict:
    """ff_trans_ppo update steps, in turns: ms a step on the host clock and
    the device busy ms of one profiled step."""
    config = chip_smoke.compose(["system.multistep_impl=pallas", "arch.num_updates=100",
                                 "arch.num_evaluation=1"], chip_smoke.TRANS_ROOT)
    scan_kernels.configure_from_config(config)
    config = check_total_timesteps(config, 1)
    env, _ = envs.make(config)
    setup = ff_trans_ppo.learner_setup(env, config, torch.device("cuda"),
                                       seed=int(config.arch.seed))
    learner, state = setup.learn, setup.learner_state
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    turns = []
    for name in ("warm-up",) + TURNS:
        with through(versions["new" if name == "warm-up" else name]):
            times = []
            for _ in range(2 if name == "warm-up" else updates):
                torch.cuda.synchronize()
                start = time.perf_counter()
                state, _ = learner.update_step(state)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - start) * 1e3)
            if name == "warm-up":
                continue
            with torch.profiler.profile(activities=activities) as prof:
                state, _ = learner.update_step(state)
                torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in events]) / 1e3
        forward_ms = sum(e.time_range.elapsed_us() for e in events
                         if "flash_forward_kernel" in e.name) / 1e3
        backward_ms = sum(e.time_range.elapsed_us() for e in events
                          if "flash_backward_kernel" in e.name) / 1e3
        turns.append({"version": name, "update_step_ms": times, "device_busy_ms": busy_ms,
                      "b2_forward_device_ms": forward_ms, "b2_backward_device_ms": backward_ms})
    steps = int(config.system.rollout_length) * int(config.arch.total_num_envs)
    mean = {name: {key: sum(sum(t[key]) if key == "update_step_ms" else t[key]
                            for t in turns if t["version"] == name)
                   / (2 * updates if key == "update_step_ms" else 2)
                   for key in ("update_step_ms", "device_busy_ms", "b2_forward_device_ms",
                               "b2_backward_device_ms")}
            for name in ("old", "new")}
    return {"env_steps_per_update": steps, "turns": turns, "mean": mean,
            "env_steps_per_second": {name: steps / (m["update_step_ms"] / 1e3)
                                     for name, m in mean.items()}}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old-source", required=True)
    parser.add_argument("--old-chunk-source", required=True)
    parser.add_argument("--updates", type=int, default=3)
    parser.add_argument("--out", default="results/ab_flash_forward.json")
    args = parser.parse_args()
    smi = chip_smoke.phase_device()
    versions = {"new": {"forward": fa.LIBRARY, "chunk": fac.LIBRARY},
                "old": old_libraries(args.old_source, args.old_chunk_source)}
    build.build_all([lib for libraries in versions.values() for lib in libraries.values()])
    ptxas = {f"{name} {kind}": chip_smoke.ptxas_instances(lib.ptxas_report())
             for name, libraries in versions.items() for kind, lib in libraries.items()}

    forward_inputs = {shape: chip_smoke.qkv_views(*shape, torch.float32, seed=50)
                      for shape in FORWARD_SHAPES}
    q, k, v = chip_smoke.qkv_views(chip_smoke.RING_BATCH, WINDOW, 4, 32, torch.float32, seed=51)
    chunks = chunk_cases(q, k, v, torch.arange(WINDOW, dtype=torch.int32, device="cuda"))
    errors = check(versions, forward_inputs, chunks)
    turns = kernel_turns(versions, forward_inputs, chunks)
    mean = {name: {key: sum(t["times"][key]["device_ms"] for t in turns if t["version"] == name) / 2
                   for key in turns[0]["times"]} for name in versions}
    bounds = {f"forward {list(shape)}": chip_smoke.attention_bound("forward", qkv[0], True)[:2]
              for shape, qkv in forward_inputs.items()}
    bounds[f"backward {list(BACKWARD_SHAPE)}"] = chip_smoke.attention_bound(
        "backward", forward_inputs[BACKWARD_SHAPE][0], True)[:2]
    bounds.update({f"chunk {case}": chip_smoke.chunk_bound(a[0], a[1], a[3], a[4], True)[:2]
                   for case, a in chunks.items()})
    report = {
        "card": smi, "dtype": "float32", "causal": True,
        "old_sources": [args.old_source, args.old_chunk_source], "max_err": errors,
        "kernel_turns": turns, "mean_device_ms": mean,
        "speedup_device": {key: mean["old"][key] / mean["new"][key] for key in mean["new"]},
        "bound_ms": {key: bound[0] for key, bound in bounds.items()},
        "bound_by": {key: bound[1] for key, bound in bounds.items()},
        "times_bound_new": {key: mean["new"][key] / bounds[key][0] for key in mean["new"]},
        "ring_torso": ring_turns(versions),
        "ff_trans_ppo": update_turns(versions, args.updates),
        "ptxas": ptxas,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
