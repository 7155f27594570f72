#!/usr/bin/env python3
"""B2's fused backward kernel against the two-kernel backward it replaced
(dQ, then dK/dV), on one CUDA card, in turns: old, new, new, old.

    python3 scripts/torch_ab_flash_backward.py --old-source PATH [--updates N] [--out PATH]

PATH is a copy of the earlier `stoix_tpu_torch/csrc/flash_attention.cu`, the
one with the entry points `flash_attention_backward_dq` and
`flash_attention_backward_dkdv` (for example `git show
<commit>:stoix_tpu_torch/csrc/flash_attention.cu` into a git-ignored
directory). It is built here with the port's nvcc flags. Both versions run at
ff_trans_ppo's minibatch shape [4096, 16, 4, 32] float32 causal, from strided
views of one fused projection, on the same o and lse from the current forward
kernel; both are checked against `plain_flash_attention_backward` (1e-5
absolute) before they are timed. Each turn times a whole backward, per launch
replayed from a CUDA graph (device ms) and per call from Python (CUDA
events). Then end to end: Anakin ff_trans_ppo's learner at its default config
(`system.multistep_impl=pallas`), N update steps a turn (default 3, after two
of warm-up) with every attention backward through one version, in the same
turns, each step timed on the host clock and ended by a device synchronize.
Prints ptxas's registers and spills for both libraries, one JSON object, and
writes it to --out (default chiprun_out/ab_flash_backward.json).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from stoix_tpu_torch import envs  # noqa: E402
from stoix_tpu_torch.kernels import build  # noqa: E402
from stoix_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from stoix_tpu_torch.ops import scan_kernels  # noqa: E402
from stoix_tpu_torch.systems.ppo.anakin import ff_trans_ppo  # noqa: E402
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps  # noqa: E402

SHAPE = (4096, 16, 4, 32)


def old_library(source: str) -> build.CudaLibrary:
    args = [fa._I] + [fa._P] * 8 + fa._SHAPE_ARGS
    return build.CudaLibrary(
        os.path.abspath(source),
        {"flash_attention_backward_dq": args, "flash_attention_backward_dkdv": args},
        error_entry="flash_attention_error_string",
    )


def old_backward(lib, q, k, v, o, lse, dout, causal):
    """The earlier backward: the dQ kernel (which writes delta), then dK/dV."""
    batch, seq, heads, _ = q.shape
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device)
    strides, shape = fa._launch_args(q, k, v, causal)
    loaded = lib.load()
    codes = (
        loaded.flash_attention_backward_dq(
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), strides, *shape),
        loaded.flash_attention_backward_dkdv(
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides, *shape),
    )
    for code in codes:
        lib.check(code, "earlier flash attention backward")
    return dq, dk, dv


def update_steps_ms(lib, updates: int) -> dict:
    """ff_trans_ppo update steps, in turns: the earlier backward, the fused
    kernel, the fused kernel, the earlier backward; ms a step per turn."""
    config = chip_smoke.compose(["system.multistep_impl=pallas", "arch.num_updates=100",
                                 "arch.num_evaluation=1"], chip_smoke.TRANS_ROOT)
    scan_kernels.configure_from_config(config)
    config = check_total_timesteps(config, 1)
    env, _ = envs.make(config)
    setup = ff_trans_ppo.learner_setup(env, config, torch.device("cuda"),
                                       seed=int(config.arch.seed))
    learner, state = setup.learn, setup.learner_state
    fused = fa.backward_kernel
    versions = {"old": lambda *args: old_backward(lib, *args), "new": fused}
    turns = []
    try:
        for name in ("warm-up", "old", "new", "new", "old"):
            fa.backward_kernel = versions.get(name, fused)
            times = []
            for _ in range(2 if name == "warm-up" else updates):
                torch.cuda.synchronize()
                start = time.perf_counter()
                state, _ = learner.update_step(state)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - start) * 1e3)
            if name != "warm-up":
                turns.append({"version": name, "update_step_ms": times})
    finally:
        fa.backward_kernel = fused
    steps = int(config.system.rollout_length) * int(config.arch.total_num_envs)
    mean = {name: sum(sum(t["update_step_ms"]) for t in turns if t["version"] == name)
            / (2 * updates) for name in versions}
    return {"env_steps_per_update": steps, "turns": turns, "mean_update_step_ms": mean,
            "env_steps_per_second": {name: steps / (ms / 1e3) for name, ms in mean.items()}}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old-source", required=True)
    parser.add_argument("--updates", type=int, default=3)
    parser.add_argument("--out", default="chiprun_out/ab_flash_backward.json")
    args = parser.parse_args()
    smi = chip_smoke.phase_device()
    old = old_library(args.old_source)
    build.build_all([fa.LIBRARY, old])
    ptxas = {name: chip_smoke.ptxas_instances(lib.ptxas_report())
             for name, lib in (("new", fa.LIBRARY), ("old", old))}

    causal = True
    q, k, v = chip_smoke.qkv_views(*SHAPE, torch.float32, seed=21)
    dout = chip_smoke.qkv_views(*SHAPE, torch.float32, seed=32)[0].contiguous()
    o, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
    runs = {"old": lambda: old_backward(old, q, k, v, o, lse, dout, causal),
            "new": lambda: fa.backward_kernel(q, k, v, o, lse, dout, causal)}
    want = fa.plain_flash_attention_backward(q, k, v, o, lse, dout, causal)
    errors = {}
    for name, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        errors[name] = [(g - w).abs().max().item() for g, w in zip(got, want)]
        if not max(errors[name]) <= 1e-5:
            raise AssertionError(f"{name} backward != plain: dq, dk, dv {errors[name]}")

    turns = []
    for name in ("old", "new", "new", "old"):
        turns.append({"version": name, "device_ms": chip_smoke.graph_ms(runs[name]),
                      "ms": chip_smoke.cuda_ms(runs[name])})
    mean = {name: {key: sum(t[key] for t in turns if t["version"] == name) / 2
                   for key in ("device_ms", "ms")} for name in runs}
    bound = chip_smoke.attention_bound("backward", q, causal)
    report = {
        "card": smi, "shape": list(SHAPE), "dtype": "float32", "causal": causal,
        "old_source": args.old_source, "max_abs_err_dq_dk_dv": errors, "turns": turns,
        "mean": mean, "speedup_device": mean["old"]["device_ms"] / mean["new"]["device_ms"],
        "bound_ms": bound[0], "bound_by": bound[1],
        "ff_trans_ppo": update_steps_ms(old, args.updates), "ptxas": ptxas,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
