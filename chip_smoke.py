#!/usr/bin/env python3
"""Smoke test of the PyTorch port (stoix_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

  1. device  — needs CUDA; TF32 off for matmuls and convolutions.
  2. build   — builds every kernel of the main path from the sources in
               stoix_tpu_torch/csrc/ with nvcc.
  3. kernel  — each kernel against its plain PyTorch version on the card, at
               the main path's shape and at a ragged shape with resets, float32
               (bitwise) and bfloat16; timed with CUDA events, per call from
               Python and per launch replayed from a CUDA graph.
  4. gae     — truncation-aware GAE through the kernel on the card against the
               `scan` impl on the CPU, on one rollout-shaped input.
  5. learn   — IdentityGame trained on the card to a return above 8.0 (the
               JAX package's learning oracle, tests/test_ff_ppo.py).
  6. train   — the main path: Anakin ff_ppo on CartPole at the default config's
               full width (1024 envs, T=16, MLP 256x256, 4 epochs x 4
               minibatches) for a few updates with system.multistep_impl=pallas.
               Every kernel's launch counter is zeroed just before and read just
               after; each must have launched (B1: once per update).

Then a `{"kernels": [...]}` line, the card's `nvidia-smi` name and power
limit, and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import torch

from stoix_tpu_torch.kernels import linear_recurrence
from stoix_tpu_torch.ops import truncated_generalized_advantage_estimation
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import config as config_lib

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
MAIN_UPDATES = 4


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def cuda_ms(fn, repeats: int = 21, inner: int = 50, warmup: int = 10) -> float:
    """Median over `repeats` of the per-call time of `inner` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, inner: int = 20) -> float:
    """Device time per call: `inner` calls captured in one CUDA graph and
    replayed, so the host's per-launch cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_ms(graph.replay, inner=1) / inner


def recurrence_inputs(t_len: int, batch: int, dtype: torch.dtype, resets: bool, seed: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    w = torch.rand((t_len, batch), generator=gen, device="cuda") * 0.99
    if resets:
        w = torch.where(torch.rand((t_len, batch), generator=gen, device="cuda") < 0.05, 0.0, w)
    d = torch.randn((t_len, batch), generator=gen, device="cuda")
    init = torch.randn((batch,), generator=gen, device="cuda")
    return w.to(dtype), d.to(dtype), init.to(dtype)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    start = time.perf_counter()
    linear_recurrence.KERNEL.build()
    emit({"phase": "build", "kernel": "linear_recurrence_reverse",
          "library": linear_recurrence.KERNEL.library_path(),
          "seconds": time.perf_counter() - start})


def phase_kernel() -> dict:
    """B1 against its plain version; returns its kernels-line entry (without launches)."""
    max_abs_err = 0.0
    for t_len, batch, dtype, resets in [
        (16, 1024, torch.float32, False),  # the main path's shape
        (17, 1000, torch.float32, True),
        (17, 1000, torch.bfloat16, True),
    ]:
        w, d, init = recurrence_inputs(t_len, batch, dtype, resets, seed=t_len * batch)
        got = linear_recurrence.linear_recurrence_reverse(w, d, init)
        torch.cuda.synchronize()
        want = linear_recurrence.plain_linear_recurrence_reverse(w, d, init)
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != want.dtype or got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"kernel output malformed at {t_len}x{batch} {dtype}")
        # Same arithmetic (one float32 FMA per step, one rounding per row): bitwise.
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at {t_len}x{batch} {dtype}: max err {err}")
        max_abs_err = max(max_abs_err, err)
        emit({"phase": "kernel", "kernel": "linear_recurrence_reverse",
              "shape": [t_len, batch], "dtype": str(dtype), "resets": resets,
              "max_abs_err": err, "bitwise": True})

    w, d, init = recurrence_inputs(16, 1024, torch.float32, False, seed=1)
    kernel_ms = cuda_ms(lambda: linear_recurrence.linear_recurrence_reverse(w, d, init))
    device_ms = graph_ms(lambda: linear_recurrence.linear_recurrence_reverse(w, d, init))
    plain_ms = cuda_ms(
        lambda: linear_recurrence.plain_linear_recurrence_reverse(w, d, init), repeats=11, inner=5
    )
    elt = w.element_size()
    t_len, batch = w.shape
    moved = (2 * t_len * batch + batch + t_len * batch) * elt  # read w, d, init; write out
    flops = 2 * t_len * batch
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    entry = {
        "name": "linear_recurrence_reverse",
        "route": "cuda",
        "source": "stoix_tpu_torch/csrc/linear_recurrence.cu",
        "replaces": "stoix_tpu/ops/scan_kernels.py:198",
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,  # per call from Python, back to back (host-bound)
        "device_ms": device_ms,  # per launch replayed from a CUDA graph
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes this recurrence
    }
    emit({"phase": "kernel_time", "shape": [t_len, batch], "dtype": "float32",
          "kernel_ms": kernel_ms, "kernel_device_ms": device_ms,
          "plain_ms_no_yardstick": plain_ms,
          "bound_ms": entry["bound_ms"], "bytes": moved, "flops": flops})
    return entry


def phase_gae() -> None:
    """GAE through the kernel on the card against `scan` on the CPU."""
    gen = torch.Generator()
    gen.manual_seed(7)
    shape = (16, 1024)
    r = torch.randn(shape, generator=gen)
    done = torch.rand(shape, generator=gen) < 0.05
    truncated = (torch.rand(shape, generator=gen) < 0.03) & ~done
    v_tm1, v_t = torch.randn(shape, generator=gen), torch.randn(shape, generator=gen)
    discount = 0.99 * (1.0 - done.float())
    args = (r, discount, 0.95)
    kwargs = dict(v_tm1=v_tm1, v_t=v_t, truncation_t=truncated.float())
    adv_cpu, tgt_cpu = truncated_generalized_advantage_estimation(*args, **kwargs, impl="scan")
    cuda = lambda x: x.cuda() if isinstance(x, torch.Tensor) else x
    before = linear_recurrence.KERNEL.launches
    adv, tgt = truncated_generalized_advantage_estimation(
        *map(cuda, args), **{k: cuda(v) for k, v in kwargs.items()}, impl="pallas"
    )
    if linear_recurrence.KERNEL.launches != before + 1:
        raise AssertionError("GAE on CUDA tensors did not launch the kernel")
    err = max((adv.cpu() - adv_cpu).abs().max().item(), (tgt.cpu() - tgt_cpu).abs().max().item())
    if not err <= 1e-6:
        raise AssertionError(f"GAE on the card disagrees with the CPU scan: {err}")
    emit({"phase": "gae", "shape": list(shape), "max_abs_err_vs_cpu_scan": err})


def compose(overrides) -> dict:
    return config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_ppo.yaml", overrides
    )


def phase_learn() -> None:
    config = compose([
        "env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=65536",
        "arch.num_evaluation=1", "arch.num_eval_episodes=32", "arch.evaluation_greedy=True",
        "arch.absolute_metric=False", "system.rollout_length=16", "system.epochs=4",
        "system.multistep_impl=pallas", "logger.use_console=False",
    ])
    start = time.perf_counter()
    final_return = ff_ppo.run_experiment(config, device="cuda")
    if not final_return > 8.0:
        raise AssertionError(f"IdentityGame did not learn on the card: return {final_return}")
    emit({"phase": "learn", "env": "identity_game", "final_return": final_return,
          "seconds": time.perf_counter() - start})


def phase_train(smi: str) -> int:
    """The main path at full width; returns B1's launches in it."""
    config = compose([
        f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
        "arch.num_eval_episodes=16", "system.multistep_impl=pallas", "logger.use_console=False",
    ])
    linear_recurrence.KERNEL.launches = 0
    start = time.perf_counter()
    final_return = ff_ppo.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    launches = linear_recurrence.KERNEL.launches
    if launches != MAIN_UPDATES:
        raise AssertionError(f"B1 launched {launches} times over {MAIN_UPDATES} updates")
    stats = runner.LAST_RUN_STATS
    train = [rec for rec in stats["history"] if rec["event"] == "trainer"]
    losses = {k: v for rec in train for k, v in rec.items() if k.endswith("loss") or k == "entropy"}
    if not train or not all(math.isfinite(v) for rec in train for k, v in rec.items()
                            if k not in ("event", "t", "t_eval")):
        raise AssertionError(f"non-finite training metrics: {train}")
    if not math.isfinite(final_return):
        raise AssertionError(f"non-finite eval return {final_return}")
    emit({"phase": "train", "env": "cartpole", "total_num_envs": int(config.arch.total_num_envs),
          "rollout_length": int(config.system.rollout_length), "updates": MAIN_UPDATES,
          "b1_launches": launches, "final_eval_return": final_return, "last_losses": losses,
          "window_seconds": stats["window_seconds"],
          "env_steps_per_second": stats["steps_per_second"], "seconds": seconds,
          "card": smi})
    return launches


def main() -> None:
    smi = phase_device()
    phase_build()
    entry = phase_kernel()
    phase_gae()
    phase_learn()
    entry["launches"] = phase_train(smi)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
