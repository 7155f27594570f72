#!/usr/bin/env python3
"""Smoke test of the PyTorch port (stoix_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

  1. device      — needs CUDA; TF32 off for matmuls and convolutions.
  2. build       — builds every kernel from the sources in stoix_tpu_torch/csrc/,
                   one nvcc per source, all started together; prints ptxas's
                   registers, spills and shared memory for every instance of
                   every library (B1's entry points, B2's forward and
                   backward, B3, and the wide route past head dim 256).
  3. kernel      — B1's generic entry point (linear recurrence) against its
                   plain PyTorch version on the card, bitwise: at ff_pqn's
                   [8, 1024] with resets, [16, 1024],
                   a ragged [17, 1000] with resets in float32 and bfloat16,
                   T in {1, 15, 16, 17, 33, 63, 64, 65, 129} (row and stage
                   edges) at 1000 columns, and a long rollout [128, 4096];
                   timed at [8, 1024], [16, 1024] and [128, 4096] with CUDA events, per
                   call from Python and per launch replayed from a CUDA graph,
                   beside an empty kernel on the same grid (the launch floor).
  4. attention   — B2 (flash attention): the forward kernel against its plain
                   version at the ff_trans_ppo path's shapes ([1024|4096|16384,
                   16, 4, 32] float32 causal, from strided qkv views), the ring
                   phase's long window [64, 512, 4, 32] causal, a ragged causal
                   [2, 300, 2, 64], a ragged non-causal [2, 100, 2, 32], a
                   bfloat16 causal [1, 128, 1, 64], and head dims 8 and 128
                   and float16 ([1024, 16, 4, 8], [2, 300, 2, 128],
                   [1024, 16, 4, 32] float16, [2, 100, 2, 8] bfloat16), each
                   also run twice and held bitwise equal; the fused backward
                   kernel against the plain backward at [4096, 16, 4, 32]
                   causal, the ragged non-causal [2, 100, 2, 32],
                   [2, 300, 2, 64] causal (five key tiles), a bfloat16 causal
                   [1, 128, 1, 64], [1024, 16, 4, 8], [2, 200, 2, 128] and
                   [1024, 16, 4, 32] float16; each kernel timed at the path's
                   shapes, beside its plain version and SDPA (forward,
                   backward alone, and both).
  5. gae         — B1's GAE entry point (truncated GAE in one launch) against
                   its plain version, bitwise, at [16, 1024] with terminations
                   and truncations, a ragged [17, 1000] and [128, 4096]; timed
                   at [16, 1024]. Then GAE through the dispatch on the card
                   against the `scan` impl on the CPU (one GAE launch, no
                   generic one), and the composed path's own run: GAE with a
                   tensor lambda and in bfloat16, every B1 counter zeroed just
                   before and read just after (generic launches only). The
                   generic entry point is on neither training path: its
                   kernels-line `launches` is 0, and its composed-path
                   launches stand under `composed_path_launches`.
  6. learn       — ff_ppo trains IdentityGame on the card to a return above 8.0
                   (the JAX package's learning oracle, tests/test_ff_ppo.py).
  7. train       — Anakin ff_ppo on CartPole at the default config's full width
                   (1024 envs, T=16, MLP 256x256, 4 epochs x 4 minibatches) for
                   a few updates with system.multistep_impl=pallas; B1's two
                   counters are zeroed just before and read just after: one
                   GAE launch per update, no generic one.
  8. trans_learn — ff_trans_ppo trains IdentityGame on the card (window 4, one
                   layer) to a return above 8.0.
  9. trans_train — Anakin ff_trans_ppo on CartPole at its default config's full
                   width (1024 envs, T=16, window 16, 2 layers of 4 heads x 32,
                   FFN 256, 4 epochs x 4 minibatches), 4 updates in 2 eval
                   windows with system.multistep_impl=pallas. Every counter is
                   zeroed just before the run and read just after; around each
                   learner call the learner's own launches are counted and must
                   be exact per update: 130 forward, 64 backward, 1 of B1's
                   GAE entry point, 0 of its generic one. The evaluator's
                   launches are the rest.
 10. ring_kernel — B3 (flash attention over one K/V chunk) against its plain
                   version on the card: every (rank, step) chunk of a 4-rank
                   causal ring over ff_trans_ppo's transformer at the torso's
                   default window (64 windows of 512, chunks [64, 128, 4, 32]
                   float32 with global positions: future, diagonal and visible
                   chunks), a non-causal chunk, Sq != Sk, a ragged chunk with
                   shuffled key positions, a bfloat16 [1, 128, 1, 64] and
                   visible chunks at head dims 8 and 128 and in float16; the
                   4 ranks' chunks folded as the ring folds them against
                   `full_attention` on the card; each shape timed.
 11. ring        — a one-rank NCCL process group (a `file://` store in a
                   temporary directory) and its mesh; the full-width torso's
                   forward on [64, 512] with ring attention as its attention
                   (exactly one B3 launch per layer, no B2) against the same
                   torso through B2 and through plain attention on the CPU;
                   timed beside the B2 torso and SDPA.
 12. c6          — attention at any head dim up to 128 and in float16 runs
                   through the kernels, as the TPU kernel takes any head dim
                   and float dtype: `best_attention` at D = 8, 128, 24 (padded
                   to 32) float32 and D = 32 float16, each one B2 forward
                   launch, and the one-rank NCCL ring at D = 8, 24 and 32
                   float16, each one B3 launch, against the CPU; then
                   ff_trans_ppo at its CPU test's small config (head_dim 8)
                   takes one update step on the card through B2's forward
                   and backward, with finite losses.

 13. c8          — head dims up to 256 run through the kernels (C8): B2's forward
                   and backward and B3 at D = 256 in float32, bfloat16 and
                   float16 against their plain versions ([1024, 16, 4, 256]
                   causal, the ragged [2, 300, 2, 256]); `best_attention` at
                   D = 200 (padded to 256) and `TransformerTorso` forward and
                   gradients at D = 256 against the CPU; one ff_trans_ppo
                   update at 4 heads x 256 through B2 (130 forward, 64
                   backward launches); the D = 256 forward, backward and B3
                   timed (a launch, a call) beside their bounds and SDPA.
 14. knobs       — ff_ppo at full width with every main-path knob on
                   (normalize_observations, update_guard=skip, fused_update,
                   update_batch_size=2, use_cached_auto_reset, the json and
                   wandb-offline sinks, save_model) for 2 eval windows:
                   env-steps/s, one B1 GAE launch an update at U = 2, device
                   launches per update (torch.profiler); a resume from window
                   1 bitwise equal to the unbroken run's final state; a
                   poisoned loss under skip ending with finite params and
                   skipped updates; IdentityGame with the same knobs above 8.0.
 15. c8_wide     — head dims past 256 through the wide kernels: the forward,
                   backward and chunk kernels against their plain versions at
                   D = 257, 384, 512, 513 and 1000 (both sides of the 512-column
                   slice boundary) in three dtypes, causal and not, at S = 40;
                   `best_attention` at D = 257 and the torso at D = 384
                   against the CPU; then their paths, every counter zeroed
                   just before and read just after: one ff_trans_ppo update
                   at 2 heads x 512 (130 wide forward and 64 wide backward
                   launches, nothing narrow) and a one-rank ring at D = 384
                   (one wide chunk launch); the three against their plain
                   versions at the update's minibatch shape [4096, 16, 2, 384]
                   and [..., 512], then timed there beside their bounds and
                   SDPA. (Runs inside the mesh of phase ring, after c6 and
                   c8.)
 16. q_learn     — ff_dqn and ff_pqn (multistep_impl=pallas) train IdentityGame
                   on the card above 8.0 (the JAX package's oracles).
 17. q_train     — ff_dqn and ff_pqn at their default configs' full width on
                   CartPole, 4 updates in 2 windows: env-steps/s per window,
                   device launches an update (torch.profiler); B1's counters
                   zeroed just before ff_pqn's run and read just after:
                   exactly one generic launch an update (Q(lambda)), no GAE
                   one; then ff_ddqn, ff_dqn_reg, ff_mdqn, ff_c51 and
                   ff_qr_dqn one window each at their default widths, finite.

 18. cont_learn  — ff_ppo_penalty with adaptive beta trains IdentityGame above
                   4.0 (the JAX package's oracle), and ff_ppo_continuous trains
                   Pendulum (64 envs, 524 288 steps, reward_scale 0.1) above
                   the midpoint of uniform random actions' return and the JAX
                   package's under the same overrides, fixed beforehand by
                   scripts/jax_oracle_thresholds.py.
 19. cont_train  — ff_ppo_continuous at its default config's full width (1024
                   Pendulum envs, T=16, MLP 256x256, the tanh-Gaussian head on
                   [-2, 2], 4 x 4 minibatches), 4 updates in 2 eval windows
                   with system.multistep_impl=pallas: B1's counters zeroed just
                   before and read just after (one GAE launch an update, no
                   generic one), env-steps/s, device launches an update; then
                   ff_ppo_penalty (CartPole, adaptive beta),
                   ff_ppo_penalty_continuous, ff_dpo_continuous (4 x 16
                   minibatches), and the Beta and diagonal-Gaussian heads, one
                   window each at their default widths, each with one GAE
                   launch an update.
 20. rec_learn   — rec_ppo trains IdentityGame above 8.0 (64 envs, 32 768
                   steps, where the JAX package's rec_ppo returns 10.0).
 21. rec_train   — rec_ppo at its default config's full width (1024 CartPole
                   envs, T=16, GRU 128 between torsos of 128, 4 x 4 minibatches
                   of env sequences), 4 updates in 2 eval windows: one GAE
                   launch an update, env-steps/s, device launches an update.
 22. rainbow_learn — ff_rainbow trains IdentityGame above 8.0 (16 envs,
                   65 536 steps, C51 on [0, 10]; the JAX package returns
                   10.0 there, scripts/jax_oracle_thresholds.py).
 23. rainbow_train — ff_rainbow at its default config's full width (128
                   CartPole envs, T = 8, a prioritised buffer of 100 000
                   steps of 4-step sequences, 4 epochs of 256, MLP 256 then
                   the noisy dueling C51 head with 128-wide streams and 51
                   atoms on [0, 500]), MAIN_UPDATES updates in 2 windows
                   through `run_experiment`, every kernel counter zeroed just
                   before and read just after (no kernel is on this path:
                   each count must stay 0); env-steps/s, device launches an
                   update (torch.profiler), the buffers' device bytes, the
                   duplicate indices `set_priorities` collapsed, one update
                   on the card against the same update on the CPU (loss and
                   priorities 1e-5 relative, params 1e-5 absolute) and
                   `set_priorities` on the card twice on indices with
                   duplicates (bitwise both times, the last occurrence of
                   every index written, on the card and on the CPU).
 24. r2d2_learn  — rec_r2d2 trains IdentityGame above 8.0 (16 envs, 131 072
                   steps; the JAX package returns 8.99 there).
 25. r2d2_train  — rec_r2d2 at its default config's full width (1024
                   CartPole envs, T = 16, a GRU of 128 between silu torsos
                   of 128, 64 sequences of 8 burn-in + 8 trained steps at
                   period 4, 2 epochs): as rainbow_train.
 26. data_parallel — data-parallel Anakin training through `run_experiment`
                   at full width (ff_ppo: CartPole, 1024 envs, 4 updates in 2
                   windows, multistep_impl=pallas, normalize_observations on,
                   so the statistics are reduced too), B1's counters zeroed
                   just before each run and read just after:
                   (a) a one-rank NCCL group that the runner forms itself from
                   `arch.distributed.*`, against the same run with no group:
                   params, optimizer states and statistics bitwise equal,
                   one GAE launch an update; the same for ff_pqn (one generic
                   launch an update);
                   (b) two ranks, started by this script as subprocesses
                   (`--data-parallel-rank`): NCCL with one card each when
                   the host has two, else both ranks on the one card over a
                   gloo group that the ranks form themselves; identical params,
                   optimizer states and statistics on both ranks after the
                   run, one GAE launch an update on each, epochs x minibatches
                   gradient all-reduces an update. Each case prints the
                   backend, the ranks, the envs a rank, the all-reduces an
                   update, env-steps/s a rank and in total, and the card.

Then a `{"kernels": [...]}` line, the card's `nvidia-smi` name and power
limit, and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import inspect
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial

import torch
import torch.distributed as dist

from stoix_tpu_torch import envs, parallel
from stoix_tpu_torch.buffers.buffers import duplicate_indices
from stoix_tpu_torch.kernels import (
    build, flash_attention, flash_attention_chunk, flash_attention_wide, linear_recurrence,
)
from stoix_tpu_torch.networks.attention import TransformerTorso
from stoix_tpu_torch.ops import best_attention, truncated_generalized_advantage_estimation
from stoix_tpu_torch.ops.ring_attention import fold_chunk, full_attention, ring_attention
from stoix_tpu_torch.systems import anakin, runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo, ff_trans_ppo
from stoix_tpu_torch.systems.q_learning import (
    ff_c51, ff_ddqn, ff_dqn, ff_dqn_reg, ff_mdqn, ff_pqn, ff_qr_dqn, q_family,
)
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from stoix_tpu_torch.utils.tree import tree_leaves, tree_map

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
MAIN_UPDATES = 4
# ff_trans_ppo's default config: layers, heads, head dim, window, rollout, epochs, minibatches.
TRANS = dict(layers=2, heads=4, head_dim=32, window=16, rollout=16, epochs=4, minibatches=4)
TRANS_ENVS = 1024
RECURRENCE_SOURCE = "stoix_tpu_torch/csrc/linear_recurrence.cu"
RECURRENCE_REPLACES = "stoix_tpu/ops/scan_kernels.py:198"
ATTENTION_SOURCE = "stoix_tpu_torch/csrc/flash_attention.cu"
ATTENTION_REPLACES = "stoix_tpu/ops/pallas_attention.py:154"
CHUNK_SOURCE = "stoix_tpu_torch/csrc/flash_attention_chunk.cu"
CHUNK_REPLACES = "stoix_tpu/ops/pallas_attention.py:255"
WIDE_SOURCE = "stoix_tpu_torch/csrc/flash_attention_wide.cu"
RING_BATCH = 64  # windows per forward in the ring phases
RING_RANKS = 4  # the ring the ring_kernel phase emulates


def cpu_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The causal reference on the host in float64, rounded to float32. The
    card's host rounds float32 batched matmuls off by up to 8.6e-5 in about
    one process of eight (PERF.md §7): the references are exact instead."""
    return full_attention(*(x.detach().cpu().double() for x in (q, k, v)), causal=True).float()


def cpu_torso_reference(torso: torch.nn.Module, x: torch.Tensor):
    """A torso's output and parameter gradients of (out ** 2).sum() on the
    host in float64 (see `cpu_attention`), rounded to float32."""
    ref = copy.deepcopy(torso).cpu().double()
    out = ref(x.cpu().double())
    (out ** 2).sum().backward()
    return out.detach().float(), [p.grad.float() for p in ref.parameters()]


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


def ptxas_instances(lines: list) -> list:
    """One record per kernel instance from ptxas's `-v` lines: registers,
    spill stores and loads (bytes), static shared memory (bytes)."""
    fields = {"registers": r"Used (\d+) registers", "spill_stores": r"(\d+) bytes spill stores",
              "spill_loads": r"(\d+) bytes spill loads", "smem": r"(\d+) bytes smem"}
    instances = []
    for line in lines:
        if "Compiling entry function" in line:
            instances.append({"kernel": line.split("'")[1], **dict.fromkeys(fields)})
        elif instances:
            for key, pattern in fields.items():
                found = re.search(pattern, line)
                if found:
                    instances[-1][key] = int(found.group(1))
    return instances


def phase_build() -> None:
    sources = ((linear_recurrence.LIBRARY, RECURRENCE_SOURCE),
               (flash_attention.LIBRARY, ATTENTION_SOURCE),
               (flash_attention_chunk.LIBRARY, CHUNK_SOURCE),
               (flash_attention_wide.LIBRARY, WIDE_SOURCE))
    libraries = [library for library, _ in sources]
    start = time.perf_counter()
    build.build_all(libraries)
    emit({"phase": "build", "libraries": [lib.library_path() for lib in libraries],
          "seconds": time.perf_counter() - start})
    for library, source in sources:
        lines = library.ptxas_report()
        for line in lines:
            print(line, flush=True)
        emit({"phase": "build_ptxas", "library": source, "instances": ptxas_instances(lines)})


def launch_floor(t_len: int, b_len: int):
    """A function that launches an empty kernel on the grid B1 takes at
    [t_len, b_len]: the practical floor of one launch."""
    entry = linear_recurrence.LIBRARY.load().linear_recurrence_empty

    def run():
        # The current stream, looked up at each launch: a graph captures on its own.
        stream = torch.cuda.current_stream().cuda_stream
        linear_recurrence.LIBRARY.check(entry(t_len, b_len, stream), "empty kernel")

    return run


def bound(moved: int, flops: int):
    """(bound_ms, bound_by): bytes at the HBM rate or float32 flops at the
    card's peak, whichever takes longer."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def recurrence_times(t_len: int, batch: int) -> dict:
    """B1's generic entry point at [t_len, batch] float32: a call, a launch,
    the empty-kernel floor, the plain version, the bound."""
    w, d, init = recurrence_inputs(t_len, batch, torch.float32, False, seed=1)
    run = partial(linear_recurrence.linear_recurrence_reverse, w, d, init)
    moved = (2 * t_len * batch + batch + t_len * batch) * 4  # read w, d, init; write out
    flops = 2 * t_len * batch
    bound_ms, bound_by = bound(moved, flops)
    return {
        "shape": [t_len, batch], "dtype": "float32",
        "ms": cuda_ms(run),  # per call from Python, back to back (host-bound)
        "device_ms": graph_ms(run),  # per launch replayed from a CUDA graph
        "empty_kernel_device_ms": graph_ms(launch_floor(t_len, batch)),
        "plain_ms": cuda_ms(partial(linear_recurrence.plain_linear_recurrence_reverse, w, d, init),
                            repeats=5, inner=3),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved, "flops": flops,
    }


def phase_kernel() -> dict:
    """B1's generic entry point against its plain version; returns its
    kernels-line entry (without launches), at ff_pqn's [8, 1024]."""
    max_abs_err = 0.0
    cases = [
        (8, 1024, torch.float32, True),  # ff_pqn's Q(lambda): [rollout, envs], truncations reset
        (16, 1024, torch.float32, False),
        (17, 1000, torch.float32, True),
        (17, 1000, torch.bfloat16, True),
        *((t_len, 1000, torch.float32, True) for t_len in (1, 15, 16, 33, 63, 64, 65, 129)),
        (128, 4096, torch.float32, True),  # a long rollout: two stages
    ]
    for t_len, batch, dtype, resets in cases:
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
        emit({"phase": "kernel", "kernel": linear_recurrence.KERNEL.name,
              "shape": [t_len, batch], "dtype": str(dtype), "resets": resets,
              "max_abs_err": err, "bitwise": True})

    shapes = [recurrence_times(8, 1024), recurrence_times(16, 1024), recurrence_times(128, 4096)]
    emit({"phase": "kernel_time", "kernel": linear_recurrence.KERNEL.name, "shapes": shapes})
    main_shape = shapes[0]  # the training path's (ff_pqn, phase q_train)
    return {
        "name": linear_recurrence.KERNEL.name, "route": "cuda", "source": RECURRENCE_SOURCE,
        "replaces": RECURRENCE_REPLACES, "max_abs_err": max_abs_err,
        **{key: main_shape[key] for key in ("shape", "ms", "device_ms", "empty_kernel_device_ms",
                                            "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,  # no single PyTorch call computes this recurrence
        "shapes": shapes,
    }


def qkv_views(batch: int, seq: int, heads: int, head_dim: int, dtype: torch.dtype, seed: int):
    """q, k, v as the main path gives them: strided views of one
    [B, S, 3, H, D] projection."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    proj = torch.randn((batch, seq, 3, heads, head_dim), generator=gen, device="cuda").to(dtype)
    return proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]


def attention_bound(kind: str, q: torch.Tensor, causal: bool, lse: bool = False):
    """(bound_ms, bound_by, bytes, flops) of one launch on these inputs: each
    input read once, each output written once; the flops of the (query, key)
    pairs the mask leaves."""
    batch, seq, heads, head_dim = q.shape
    tensor = q.numel() * q.element_size()  # one [B, S, H, D] operand
    stat = batch * heads * seq * 4  # one float32 [B, H, S] row statistic
    pairs = batch * heads * (seq * (seq + 1) // 2 if causal else seq * seq)
    if kind == "forward":  # read q, k, v; write o (and lse)
        moved, flops = 4 * tensor + (stat if lse else 0), 4 * head_dim * pairs
    else:  # backward: read q, k, v, o, dO, lse; write dQ, dK, dV
        moved = 8 * tensor + stat
        # q.k and dO.v (4D), dV, dK and dQ (6D) per pair; delta = rowsum(dO.o)
        flops = 10 * head_dim * pairs + 2 * batch * seq * heads * head_dim
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), moved, flops


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """PyTorch's one call for the same function: the yardstick, never used by the port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal
    ).transpose(1, 2)


def phase_attention() -> list:
    """B2's two kernels against their plain versions; returns their
    kernels-line entries (without launches)."""
    fa = flash_attention
    # Same tiles, another summation order than the plain version: float32 is
    # held at 1e-5 absolute, bfloat16 at 2e-2 (JAX's own bf16 tolerance for
    # this kernel, tests/test_pallas_attention.py), float16 at 2e-3 (two
    # float16 ulps in [1, 2)).
    tolerance = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
    path = [((b, TRANS["window"], TRANS["heads"], TRANS["head_dim"]), True, torch.float32)
            for b in (TRANS_ENVS, 4 * TRANS_ENVS, TRANS["rollout"] * TRANS_ENVS)]
    errors = {"forward": 0.0, "backward": 0.0}
    long = ((RING_BATCH, 512, TRANS["heads"], TRANS["head_dim"]), True, torch.float32)
    for seed, (shape, causal, dtype) in enumerate(path + [
        long,
        ((2, 300, 2, 64), True, torch.float32),
        ((2, 100, 2, 32), False, torch.float32),
        ((1, 128, 1, 64), True, torch.bfloat16),
        # Head dims 8 and 128 and float16 (C6).
        ((TRANS_ENVS, 16, 4, 8), True, torch.float32),
        ((2, 300, 2, 128), True, torch.float32),
        ((TRANS_ENVS, 16, 4, 32), True, torch.float16),
        ((2, 100, 2, 8), False, torch.bfloat16),
    ]):
        q, k, v = qkv_views(*shape, dtype, seed=seed)
        got, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
        again, lse_again = fa.forward_kernel(q, k, v, causal, need_lse=True)
        torch.cuda.synchronize()
        if not (torch.equal(got, again) and torch.equal(lse, lse_again)):
            raise AssertionError(f"forward kernel not deterministic at {shape} {dtype}")
        want, want_lse = fa.plain_flash_attention_forward(q, k, v, causal, need_lse=True)
        err = (got.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        if got.dtype != dtype or got.shape != q.shape or not torch.isfinite(got).all():
            raise AssertionError(f"forward kernel output malformed at {shape} {dtype}")
        if not (err <= tolerance[dtype] and lse_err <= 1e-5):
            raise AssertionError(f"forward != plain at {shape} {dtype}: {err}, lse {lse_err}")
        if dtype == torch.float32:
            errors["forward"] = max(errors["forward"], err)
        emit({"phase": "attention", "kernel": "flash_attention_forward", "shape": list(shape),
              "causal": causal, "dtype": str(dtype), "max_abs_err": err,
              "lse_max_abs_err": lse_err, "tolerance": tolerance[dtype], "bitwise_twice": True})

    # The backward: the path's shape, a ragged one, one of five 64-key tiles
    # (dQ partials summed), a bfloat16 one, and head dims 8 and 128 and
    # float16 (C6). The 16-bit types are also held relative, at their own
    # tolerance: above 2 a bf16 ulp is 1.6e-2 or more (a float16 ulp 2e-3),
    # and the two fp32 sums may round to neighbouring values.
    for seed, (shape, causal, dtype) in enumerate([
        ((4 * TRANS_ENVS, 16, 4, 32), True, torch.float32),
        ((2, 100, 2, 32), False, torch.float32),
        ((2, 300, 2, 64), True, torch.float32),
        ((1, 128, 1, 64), True, torch.bfloat16),
        ((TRANS_ENVS, 16, 4, 8), True, torch.float32),
        ((2, 200, 2, 128), True, torch.float32),
        ((TRANS_ENVS, 16, 4, 32), True, torch.float16),
    ]):
        q, k, v = qkv_views(*shape, dtype, seed=10 + seed)
        dout = qkv_views(*shape, dtype, seed=30 + seed)[0].contiguous()
        o, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
        got = fa.backward_kernel(q, k, v, o, lse, dout, causal)
        torch.cuda.synchronize()
        want = fa.plain_flash_attention_backward(q, k, v, o, lse, dout, causal)
        rtol = 0.0 if dtype == torch.float32 else tolerance[dtype]
        errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
        held = all(bool(((g.float() - w.float()).abs() <= tolerance[dtype] + rtol * w.float().abs())
                        .all()) for g, w in zip(got, want))
        if any(g.dtype != dtype or g.shape != q.shape or not torch.isfinite(g).all() for g in got):
            raise AssertionError(f"backward kernel output malformed at {shape} {dtype}")
        if not held:
            raise AssertionError(f"backward kernel != plain at {shape} {dtype}: dq, dk, dv {errs}")
        if dtype == torch.float32:
            errors["backward"] = max(errors["backward"], *errs)
        emit({"phase": "attention", "kernel": "flash_attention_backward", "shape": list(shape),
              "causal": causal, "dtype": str(dtype), "max_abs_err_dq_dk_dv": errs,
              "tolerance": tolerance[dtype], "rtol": rtol})

    # Times at the path's shapes: the forward at each batch it runs at and at
    # the ring phase's long window, the backward at the minibatch's.
    shapes = []
    for shape, causal, _ in path + [long]:
        q, k, v = qkv_views(*shape, torch.float32, seed=20)
        bound, bound_by, moved, flops = attention_bound("forward", q, causal)
        shapes.append({
            "shape": list(shape),
            "ms": cuda_ms(lambda: fa.forward_kernel(q, k, v, causal)),
            "device_ms": graph_ms(lambda: fa.forward_kernel(q, k, v, causal)),
            "with_lse_device_ms": graph_ms(lambda: fa.forward_kernel(q, k, v, causal, True)),
            "plain_ms": cuda_ms(lambda: fa.plain_flash_attention_forward(q, k, v, causal),
                                repeats=5, inner=3),
            "library_ms": cuda_ms(lambda: sdpa(q, k, v, causal)),
            "bound_ms": bound, "bound_by": bound_by, "bytes": moved, "flops": flops,
        })
    emit({"phase": "attention_time", "kernel": "flash_attention_forward", "shapes": shapes})
    main_shape = shapes[1]  # the minibatch forward, [4096, 16, 4, 32]
    forward_entry = {
        "name": fa.FORWARD.name, "route": "cuda", "source": ATTENTION_SOURCE,
        "replaces": ATTENTION_REPLACES, "max_abs_err": errors["forward"],
        **{key: main_shape[key] for key in
           ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shapes": shapes,
    }

    shape, causal = (4 * TRANS_ENVS, 16, 4, 32), True
    q, k, v = qkv_views(*shape, torch.float32, seed=21)
    dout = qkv_views(*shape, torch.float32, seed=32)[0].contiguous()
    o, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
    leaf = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    library_out = sdpa(*leaf, causal)

    def ours_fwd_bwd():
        out = fa.FlashAttention.apply(*leaf, causal)
        out.backward(dout)

    def sdpa_fwd_bwd():
        sdpa(*leaf, causal).backward(dout)

    def sdpa_bwd():  # SDPA's backward alone, on one saved forward
        torch.autograd.grad(library_out, leaf, dout, retain_graph=True)

    run = lambda: fa.backward_kernel(q, k, v, o, lse, dout, causal)  # noqa: E731
    bound, bound_by, moved, flops = attention_bound("backward", q, causal)
    backward_entry = {
        "name": fa.BACKWARD.name, "route": "cuda", "source": ATTENTION_SOURCE,
        "replaces": ATTENTION_REPLACES, "max_abs_err": errors["backward"], "shape": list(shape),
        "ms": cuda_ms(run), "device_ms": graph_ms(run),
        "plain_ms": cuda_ms(
            lambda: fa.plain_flash_attention_backward(q, k, v, o, lse, dout, causal),
            repeats=5, inner=3),
        "bound_ms": bound, "bound_by": bound_by, "bytes": moved, "flops": flops,
        "library_ms": cuda_ms(sdpa_bwd, repeats=11, inner=20),
        "fwd_bwd_ms": cuda_ms(ours_fwd_bwd, repeats=11, inner=20),
        "library_fwd_bwd_ms": cuda_ms(sdpa_fwd_bwd, repeats=11, inner=20),
    }
    emit({"phase": "attention_time", "kernel": fa.BACKWARD.name,
          **{key: backward_entry[key] for key in (
              "shape", "ms", "device_ms", "plain_ms", "bound_ms", "library_ms", "fwd_bwd_ms",
              "library_fwd_bwd_ms")}})
    return [forward_entry, backward_entry]


def gae_inputs(t_len: int, batch: int, seed: int, device: str = "cuda"):
    """r, discount, v_tm1, v_t, truncation [T, B] float32 as a rollout gives
    them: terminations zero the discount, truncations mark 1.0 elsewhere."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (t_len, batch)
    r = torch.randn(shape, generator=gen, device=device)
    done = torch.rand(shape, generator=gen, device=device) < 0.05
    truncated = (torch.rand(shape, generator=gen, device=device) < 0.03) & ~done
    v_tm1 = torch.randn(shape, generator=gen, device=device)
    v_t = torch.randn(shape, generator=gen, device=device)
    return r, 0.99 * (1.0 - done.float()), v_tm1, v_t, truncated.float()


def phase_gae() -> tuple:
    """B1's GAE entry point against its plain version, and GAE through the
    dispatch; returns the entry point's kernels-line entry (without launches)
    and the generic entry point's launches on the composed path's own run."""
    lr = linear_recurrence
    lam = 0.95
    max_abs_err = 0.0
    for t_len, batch in ((16, 1024), (17, 1000), (128, 4096)):
        args = gae_inputs(t_len, batch, seed=t_len + batch)
        got = lr.truncated_gae(*args, lam)
        torch.cuda.synchronize()
        want = lr.plain_truncated_gae(*args, lam)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if any(g.shape != (t_len, batch) or not torch.isfinite(g).all() for g in got):
            raise AssertionError(f"GAE kernel output malformed at {t_len}x{batch}")
        # The plain version's op order and roundings: bitwise.
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"GAE kernel != plain at {t_len}x{batch}: max err {err}")
        max_abs_err = max(max_abs_err, err)
        emit({"phase": "gae", "kernel": lr.GAE_KERNEL.name, "shape": [t_len, batch],
              "truncation": True, "max_abs_err": err, "bitwise": True})

    # Through the dispatch: the card against `scan` on the CPU.
    cpu = [x.cpu() for x in gae_inputs(16, 1024, seed=7)]
    want = truncated_generalized_advantage_estimation(
        cpu[0], cpu[1], lam, v_tm1=cpu[2], v_t=cpu[3], truncation_t=cpu[4], impl="scan")
    card = [x.cuda() for x in cpu]
    before = [c.launches for c in lr.COUNTERS]
    got = truncated_generalized_advantage_estimation(
        card[0], card[1], lam, v_tm1=card[2], v_t=card[3], truncation_t=card[4], impl="pallas")
    if [c.launches - b for c, b in zip(lr.COUNTERS, before)] != [0, 1]:
        raise AssertionError("GAE on CUDA tensors did not take exactly one GAE launch")
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError("GAE on the card != the CPU scan")
    emit({"phase": "gae", "route": "dispatch, impl=pallas", "shape": [16, 1024],
          "bitwise_vs_cpu_scan": True})

    # The composed path's own run (a tensor lambda; bfloat16): the generic
    # entry point between separate elementwise ops, each held against the CPU.
    for counter in lr.COUNTERS:
        counter.launches = 0
    lam_t = torch.full((16, 1024), lam)
    composed = {
        "tensor lambda": (card[:2] + [lam_t.cuda()] + card[2:], cpu[:2] + [lam_t] + cpu[2:]),
        "bfloat16": ([x.bfloat16() for x in card[:2]] + [lam] + [x.bfloat16() for x in card[2:]],
                     [x.bfloat16() for x in cpu[:2]] + [lam] + [x.bfloat16() for x in cpu[2:]]),
    }
    outputs = {}
    for name, (on_card, on_cpu) in composed.items():
        r, discount, lam_in, v_tm1, v_t, trunc = on_card
        outputs[name] = (truncated_generalized_advantage_estimation(
            r, discount, lam_in, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc, impl="pallas"), on_cpu)
    composed_launches = {c.name: c.launches for c in lr.COUNTERS}
    if composed_launches != {lr.KERNEL.name: len(composed), lr.GAE_KERNEL.name: 0}:
        raise AssertionError(f"the composed path launched {composed_launches}")
    for name, (got, on_cpu) in outputs.items():
        r, discount, lam_in, v_tm1, v_t, trunc = on_cpu
        want = truncated_generalized_advantage_estimation(
            r, discount, lam_in, v_tm1=v_tm1, v_t=v_t, truncation_t=trunc, impl="pallas")
        # The CPU runs the same composed path with the kernel's plain version.
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"composed GAE ({name}) on the card != on the CPU")
    emit({"phase": "gae", "route": "composed (tensor lambda, bfloat16)",
          "launches": composed_launches, "bitwise_vs_cpu": True})

    args = gae_inputs(16, 1024, seed=8)
    t_len, batch = args[0].shape
    run = partial(lr.truncated_gae, *args, lam)
    moved = (5 + 2) * t_len * batch * 4  # read r, discount, v_tm1, v_t, truncation; write 2
    flops = 9 * t_len * batch  # 2 FMAs, 2 multiplies, 3 adds a step
    bound_ms, bound_by = bound(moved, flops)
    entry = {
        "name": lr.GAE_KERNEL.name, "route": "cuda", "source": RECURRENCE_SOURCE,
        "replaces": f"{RECURRENCE_REPLACES} with stoix_tpu/ops/multistep.py:73",
        "max_abs_err": max_abs_err, "shape": [t_len, batch],
        "ms": cuda_ms(run), "device_ms": graph_ms(run),
        "empty_kernel_device_ms": graph_ms(launch_floor(t_len, batch)),
        "plain_ms": cuda_ms(partial(lr.plain_truncated_gae, *args, lam), repeats=5, inner=3),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved, "flops": flops,
        "library_ms": None,  # no single PyTorch call computes GAE
    }
    emit({"phase": "gae_time", **entry})
    return entry, composed_launches[lr.KERNEL.name]


def compose(overrides, root: str = "default/anakin/default_ff_ppo.yaml") -> dict:
    return config_lib.compose(config_lib.default_config_dir(), root, overrides)


TRANS_ROOT = "default/anakin/default_ff_trans_ppo.yaml"
IDENTITY = ["env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=65536",
            "arch.num_evaluation=1", "arch.num_eval_episodes=32", "arch.evaluation_greedy=True",
            "arch.absolute_metric=False", "logger.use_console=False"]


def phase_learn() -> None:
    config = compose(IDENTITY + ["system.rollout_length=16", "system.epochs=4",
                                 "system.multistep_impl=pallas"])
    start = time.perf_counter()
    final_return = ff_ppo.run_experiment(config, device="cuda")
    if not final_return > 8.0:
        raise AssertionError(f"IdentityGame did not learn on the card: return {final_return}")
    emit({"phase": "learn", "env": "identity_game", "final_return": final_return,
          "seconds": time.perf_counter() - start})


def phase_train(smi: str) -> int:
    """The main path at full width; returns B1's GAE launches in it."""
    lr = linear_recurrence
    config = compose([
        f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
        "arch.num_eval_episodes=16", "system.multistep_impl=pallas", "logger.use_console=False",
    ])
    for counter in lr.COUNTERS:
        counter.launches = 0
    start = time.perf_counter()
    final_return = ff_ppo.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    launches = lr.GAE_KERNEL.launches
    if (lr.KERNEL.launches, launches) != (0, MAIN_UPDATES):
        raise AssertionError(f"B1 launched {lr.KERNEL.launches} generic and {launches} GAE "
                             f"times over {MAIN_UPDATES} updates, not 0 and {MAIN_UPDATES}")
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
          "b1_gae_launches": launches, "b1_generic_launches": lr.KERNEL.launches,
          "final_eval_return": final_return, "last_losses": losses,
          "window_seconds": stats["window_seconds"],
          "env_steps_per_second": stats["steps_per_second"], "seconds": seconds,
          "card": smi})
    return launches


def phase_trans_learn() -> None:
    # The JAX package's ff_trans_ppo returns 10.0 with these overrides on the CPU.
    config = compose(IDENTITY + ["system.window_length=4", "system.num_layers=1",
                                 "system.multistep_impl=pallas"], TRANS_ROOT)
    start = time.perf_counter()
    final_return = ff_trans_ppo.run_experiment(config, device="cuda")
    if not final_return > 8.0:
        raise AssertionError(f"ff_trans_ppo did not learn IdentityGame on the card: {final_return}")
    emit({"phase": "trans_learn", "env": "identity_game", "final_return": final_return,
          "seconds": time.perf_counter() - start})


def _counts(counters) -> dict:
    return {c.name: c.launches for c in counters}


def phase_trans_train(smi: str) -> dict:
    """ff_trans_ppo's main path at full width; returns each kernel's launches
    in the run, split into the learner's and the evaluator's."""
    fa, lr = flash_attention, linear_recurrence
    counters = [fa.FORWARD, fa.BACKWARD, *lr.COUNTERS]
    layers = TRANS["layers"]
    per_update = {  # the learner's launches in one update step
        fa.FORWARD.name: 2 * layers * TRANS["rollout"] + layers
        + 2 * layers * TRANS["epochs"] * TRANS["minibatches"],
        fa.BACKWARD.name: 2 * layers * TRANS["epochs"] * TRANS["minibatches"],
        lr.KERNEL.name: 0,  # GAE takes the GAE entry point, never the generic one
        lr.GAE_KERNEL.name: 1,
    }
    config = compose([
        f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
        "arch.num_eval_episodes=16", "system.multistep_impl=pallas", "logger.use_console=False",
    ], TRANS_ROOT)
    if (int(config.system.num_layers), int(config.arch.total_num_envs)) != (layers, TRANS_ENVS):
        raise AssertionError("the default ff_trans_ppo config changed; update TRANS")
    learner = dict.fromkeys(per_update, 0)
    original_setup = ff_trans_ppo.learner_setup

    def counted_setup(env, cfg, device, seed):
        setup = original_setup(env, cfg, device, seed)

        def learn(state):
            before = _counts(counters)
            output = setup.learn(state)
            for name, count in _counts(counters).items():
                learner[name] += count - before[name]
            return output

        return setup._replace(learn=learn)

    for counter in counters:
        counter.launches = 0
    ff_trans_ppo.learner_setup = counted_setup
    start = time.perf_counter()
    try:
        final_return = ff_trans_ppo.run_experiment(config, device="cuda")
    finally:
        ff_trans_ppo.learner_setup = original_setup
    seconds = time.perf_counter() - start
    total = _counts(counters)

    expected = {name: n * MAIN_UPDATES for name, n in per_update.items()}
    if learner != expected:
        raise AssertionError(f"learner launches {learner} != {expected} in {MAIN_UPDATES} updates")
    evaluator = {name: total[name] - learner[name] for name in total}
    stats = runner.LAST_RUN_STATS
    # The stateful evaluator steps until its longest episode ends: L forward
    # launches per step, nothing else.
    eval_steps = sum(int(rec["episode_length/max"]) for rec in stats["history"]
                     if rec["event"] in ("evaluator", "absolute"))
    if evaluator != {**dict.fromkeys(total, 0), fa.FORWARD.name: layers * eval_steps}:
        raise AssertionError(f"evaluator launches {evaluator} over {eval_steps} eval steps")
    train = [rec for rec in stats["history"] if rec["event"] == "trainer"]
    if not train or not all(math.isfinite(v) for rec in train for k, v in rec.items()
                            if k not in ("event", "t", "t_eval")):
        raise AssertionError(f"non-finite training metrics: {train}")
    if not math.isfinite(final_return):
        raise AssertionError(f"non-finite eval return {final_return}")
    emit({"phase": "trans_train", "env": "cartpole", "total_num_envs": TRANS_ENVS,
          "updates": MAIN_UPDATES, "learner_launches": learner,
          "learner_launches_per_update": per_update, "evaluator_launches": evaluator,
          "eval_steps": eval_steps, "final_eval_return": final_return,
          "last_losses": train[-1], "window_seconds": stats["window_seconds"],
          "env_steps_per_second": stats["steps_per_second"], "seconds": seconds, "card": smi})
    return {"learner": learner, "evaluator": evaluator, "total": total}


def ring_width() -> dict:
    """The ring phases' transformer: ff_trans_ppo's default config (layers,
    heads, head dim, FFN, env) over the torso's default window."""
    config = compose([], TRANS_ROOT)
    window = inspect.signature(TransformerTorso).parameters["max_timesteps"].default
    return dict(layers=int(config.system.num_layers), heads=int(config.system.num_heads),
                head_dim=int(config.system.head_dim), ffn=int(config.system.ffn_dim),
                window=int(window),
                obs=ff_trans_ppo.observation_width(envs.make(config)[0]))


def chunk_bound(q, k, q_pos, k_pos, causal: bool):
    """(bound_ms, bound_by, bytes, flops) of one B3 launch on these inputs,
    after `attention_bound`: the flops of the (query, key) pairs these
    positions leave; q, k, v read once if any pair is left (a chunk wholly in
    the future needs none of them), positions read once, pv, m and l written."""
    batch, q_len, heads, head_dim = q.shape
    visible = q_pos[:, None].long() >= k_pos[None, :].long()
    pairs = batch * heads * (int(visible.sum()) if causal else q_len * k.shape[1])
    stat = batch * heads * q_len * 4
    moved = batch * q_len * heads * head_dim * 4 + 2 * stat + 4 * (q_len + k.shape[1])
    if pairs:
        moved += q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    flops = 4 * head_dim * pairs
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), moved, flops


def phase_ring_kernel(width: dict) -> dict:
    """B3 against its plain version; returns its kernels-line entry (without
    launches)."""
    fac = flash_attention_chunk
    # The kernel and its plain version take the same inputs widened to float32
    # and fold the same key tiles in another summation order; both write
    # float32, so float32 and bfloat16 inputs are held at 1e-5 (m absolute, l
    # and pv relative to l). The fold against full attention at 2e-5, JAX's
    # own tolerance (tests/test_pallas_attention.py).
    tolerance, fold_tolerance = 1e-5, 2e-5
    batch, window, heads, head_dim = RING_BATCH, width["window"], width["heads"], width["head_dim"]
    local = window // RING_RANKS
    q, k, v = qkv_views(batch, window, heads, head_dim, torch.float32, seed=40)
    positions = torch.arange(window, dtype=torch.int32, device=q.device)
    max_err = max_abs_err = 0.0

    def check(name, args, causal):
        nonlocal max_err, max_abs_err
        got = fac.chunk_kernel(*args, causal=causal)
        torch.cuda.synchronize()
        want = fac.plain_flash_attention_chunk(*args, causal=causal)
        errs = fac.chunk_errors(got, want)
        abs_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if not all(torch.isfinite(x).all() for x in got) or not max(errs) <= tolerance:
            raise AssertionError(f"chunk kernel != plain at {name}: m, l, pv errors {errs}")
        max_err, max_abs_err = max(max_err, *errs), max(max_abs_err, abs_err)
        emit({"phase": "ring_kernel", "case": name, "q": list(args[0].shape),
              "k": list(args[1].shape), "dtype": str(args[0].dtype), "causal": causal,
              "errors_m_l_pv": errs, "max_abs_err": abs_err, "tolerance": tolerance})
        return got

    def chunk_args(rank, src):
        rows, keys = slice(rank * local, (rank + 1) * local), slice(src * local, (src + 1) * local)
        return q[:, rows], k[:, keys], v[:, keys], positions[rows], positions[keys]

    outputs = []
    for rank in range(RING_RANKS):
        acc = (torch.full((batch, heads, local), float("-inf"), device=q.device),
               torch.zeros((batch, heads, local), device=q.device),
               torch.zeros((batch, local, heads, head_dim), device=q.device))
        for step in range(RING_RANKS):  # in the ring's order: source (rank + step) % R
            src = (rank + step) % RING_RANKS
            kind = "future" if src > rank else "diagonal" if src == rank else "visible"
            acc = fold_chunk(acc, *check(f"rank {rank} source {src} ({kind})",
                                         chunk_args(rank, src), True))
        outputs.append(acc[2] / torch.where(acc[1] == 0.0, 1.0, acc[1]).permute(0, 2, 1)[..., None])
    fold_err = (torch.cat(outputs, dim=1) - full_attention(q, k, v, causal=True)).abs().max().item()
    if not fold_err <= fold_tolerance:
        raise AssertionError(f"4-rank fold of the chunk kernel != full attention: {fold_err}")
    emit({"phase": "ring_kernel", "case": f"{RING_RANKS}-rank causal ring folded",
          "shape": [batch, window, heads, head_dim], "max_abs_err_vs_full_attention": fold_err,
          "tolerance": fold_tolerance})

    check("non-causal chunk", chunk_args(1, 2), False)
    check("Sq != Sk", (q[:, local:2 * local], k[:, :200], v[:, :200],
                       positions[local:2 * local], positions[:200]), True)
    rq, rk, rv = qkv_views(3, 77, 2, 32, torch.float32, seed=41)
    shuffled = torch.randperm(45, generator=torch.Generator(device=q.device).manual_seed(42),
                              device=q.device).to(torch.int32) + 10
    check("ragged, shuffled key positions", (rq, rk[:, :45], rv[:, :45],
                                             positions[:77], shuffled), True)
    bq, bk, bv = qkv_views(1, 128, 1, 64, torch.bfloat16, seed=43)
    check("bfloat16 diagonal", (bq, bk, bv, positions[:128], positions[:128]), True)
    # Head dims 8 and 128 and float16 (C6), each at a visible 4-rank chunk.
    for seed, (dim, dtype) in enumerate(((8, torch.float32), (128, torch.float32),
                                         (32, torch.float16))):
        cq, ck, cv = qkv_views(batch, 2 * local, heads, dim, dtype, seed=45 + seed)
        check(f"visible chunk, D = {dim} {dtype}",
              (cq[:, local:], ck[:, :local], cv[:, :local], positions[local:2 * local],
               positions[:local]), True)
    # The one-rank ring's launch: the whole window, several query row blocks
    # per (batch, head), each with its own causal bound.
    check("one-rank window", (q, k, v, positions, positions), True)

    # Times: the three kinds of 4-rank chunk, and the one-rank ring's chunk
    # (the whole window), which is what the ring phase launches.
    shapes = []
    for name, args in (("visible", chunk_args(1, 0)), ("diagonal", chunk_args(1, 1)),
                       ("future", chunk_args(1, 2)), ("one-rank", (q, k, v, positions, positions))):
        bound, bound_by, moved, flops = chunk_bound(args[0], args[1], args[3], args[4], True)
        shapes.append({
            "case": name, "q": list(args[0].shape), "k": list(args[1].shape),
            "ms": cuda_ms(lambda: fac.chunk_kernel(*args, causal=True)),
            "device_ms": graph_ms(lambda: fac.chunk_kernel(*args, causal=True)),
            "plain_ms": cuda_ms(lambda: fac.plain_flash_attention_chunk(*args, causal=True),
                                repeats=5, inner=3),
            "bound_ms": bound, "bound_by": bound_by, "bytes": moved, "flops": flops,
        })
    emit({"phase": "ring_kernel_time", "kernel": fac.KERNEL.name, "shapes": shapes})
    main_shape = shapes[-1]
    return {
        "name": fac.KERNEL.name, "route": "cuda", "source": CHUNK_SOURCE,
        # max_abs_err: the largest |kernel - plain| over pv, m and l of every
        # case; max_err_rel_l: what the tolerance holds (m absolute, l and pv
        # relative to the row's l).
        "replaces": CHUNK_REPLACES, "max_abs_err": max_abs_err, "max_err_rel_l": max_err,
        "shape": main_shape["q"],
        **{key: main_shape[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        # No single PyTorch call returns the unnormalised pv with its stats;
        # SDPA's time on the composed op is under the ring phase.
        "library_ms": None,
        "shapes": shapes,
    }


@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank NCCL process group (a `file://` store in a temporary
    directory) and its mesh, destroyed on exit."""
    with tempfile.TemporaryDirectory() as tmp:
        config = config_lib.Config.from_dict({"arch": {"distributed": {
            "coordinator_address": "file://" + os.path.join(tmp, "store"),
            "num_processes": 1, "process_id": 0,
        }}})
        parallel.maybe_initialize_distributed(config, device="cuda")
        try:
            yield parallel.create_mesh({"data": 1}, device="cuda")
        finally:
            dist.destroy_process_group()


def phase_ring(width: dict, smi: str, mesh) -> dict:
    """The full-width torso's forward through a one-rank NCCL ring; returns
    B3's launches in that forward and the timings."""
    fa, fac = flash_attention, flash_attention_chunk
    tolerance = 1e-4
    ranks = parallel.axis_size(mesh, "data")

    def torso(attention_fn=None):
        return TransformerTorso(
            width["obs"], width["layers"], width["heads"], width["head_dim"],
            width["ffn"], attention_fn=attention_fn,
            generator=torch.Generator().manual_seed(0),
        )

    ring_torso = torso(partial(ring_attention, group=mesh.get_group("data"))).cuda()
    flash_torso = torso().cuda()  # best_attention: B2 on the card
    flash_torso.load_state_dict(ring_torso.state_dict())
    cpu_torso = copy.deepcopy(flash_torso).cpu().double()  # float64 full attention
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((RING_BATCH, width["window"], width["obs"]), generator=gen)
    x_card = x.cuda()

    for counter in (*fa.COUNTERS, fac.KERNEL):
        counter.launches = 0
    with torch.no_grad():
        ring_out = ring_torso(x_card)
        torch.cuda.synchronize()
        launches = {c.name: c.launches for c in (*fa.COUNTERS, fac.KERNEL)}
        flash_out = flash_torso(x_card)
        cpu_out = cpu_torso(x.double()).float()
    expected = {**{c.name: 0 for c in fa.COUNTERS},
                fac.KERNEL.name: width["layers"] * ranks}
    if launches != expected:
        raise AssertionError(f"ring torso forward launched {launches}, not {expected}")
    errs = {"ring_vs_flash": (ring_out - flash_out).abs().max().item(),
            "ring_vs_cpu": (ring_out.cpu() - cpu_out).abs().max().item(),
            "flash_vs_cpu": (flash_out.cpu() - cpu_out).abs().max().item()}
    if not torch.isfinite(ring_out).all() or not max(errs.values()) <= tolerance:
        raise AssertionError(f"ring torso disagrees: {errs}")

    q, k, v = qkv_views(RING_BATCH, width["window"], width["heads"], width["head_dim"],
                        torch.float32, seed=44)
    group = mesh.get_group("data")
    torso_ms = partial(cuda_ms, repeats=5, inner=5)
    with torch.no_grad():
        times = {
            "ring_torso_forward_ms": torso_ms(lambda: ring_torso(x_card)),
            "flash_torso_forward_ms": torso_ms(lambda: flash_torso(x_card)),
            "ring_attention_ms": cuda_ms(lambda: ring_attention(q, k, v, group, True)),
            "flash_attention_ms": cuda_ms(lambda: fa.flash_attention(q, k, v, True)),
            "sdpa_ms": cuda_ms(lambda: sdpa(q, k, v, True)),
        }
    tokens = RING_BATCH * width["window"]
    emit({"phase": "ring", "mesh": {"data": ranks}, "backend": "nccl",
          "torso": {k: width[k] for k in ("layers", "heads", "head_dim", "ffn", "window")},
          "batch": RING_BATCH, "launches_per_forward": launches, "max_abs_err": errs,
          "tolerance": tolerance, **times,
          "ring_torso_tokens_per_s": tokens / (times["ring_torso_forward_ms"] / 1e3),
          "flash_torso_tokens_per_s": tokens / (times["flash_torso_forward_ms"] / 1e3),
          "card": smi})
    return {"launches": launches[fac.KERNEL.name], "sdpa_ms": times["sdpa_ms"],
            "ring_attention_ms": times["ring_attention_ms"]}


# ff_trans_ppo at its CPU test's small config (tests/test_torch_ff_trans_ppo.py):
# head_dim 8, a quarter of the default's 32.
C6_TRANS = ["system.window_length=4", "system.num_layers=1", "system.num_heads=2",
            "system.head_dim=8", "system.ffn_dim=32", "arch.total_num_envs=16",
            "system.rollout_length=8", "system.num_minibatches=2", "env=identity_game",
            "system.multistep_impl=pallas", "logger.use_console=False"]


def phase_c6(mesh, smi: str) -> None:
    """Attention at any head dim up to 128 and in float16 runs through the
    kernels on the card (C6): `best_attention` and a one-rank NCCL ring against
    the CPU, each launching its kernel; then ff_trans_ppo at head_dim 8 trains
    a step there through B2."""
    fa, fac = flash_attention, flash_attention_chunk
    counters = (*fa.COUNTERS, fac.KERNEL)
    # float32 at 2e-5, the attention tolerance (JAX's own); float16 against the
    # CPU's float32 attention on the same float16 inputs at 2e-3 absolute and
    # relative: the kernel computes in fp32 and rounds once to float16.
    tolerance = {torch.float32: (0.0, 2e-5), torch.float16: (2e-3, 2e-3)}
    group = mesh.get_group("data")
    cases = [("best_attention", 8, torch.float32, fa.FORWARD),
             ("best_attention", 128, torch.float32, fa.FORWARD),
             ("best_attention", 32, torch.float16, fa.FORWARD),
             ("best_attention", 24, torch.float32, fa.FORWARD),  # padded to 32
             ("ring_attention", 8, torch.float32, fac.KERNEL),
             ("ring_attention", 32, torch.float16, fac.KERNEL),
             ("ring_attention", 24, torch.float32, fac.KERNEL)]
    for seed, (name, head_dim, dtype, counter) in enumerate(cases):
        q, k, v = qkv_views(64, 16, 4, head_dim, dtype, seed=60 + seed)
        for each in counters:
            each.launches = 0
        if name == "best_attention":
            got = best_attention(q, k, v, causal=True)
        else:
            got = ring_attention(q, k, v, group, causal=True)
        torch.cuda.synchronize()
        launches = {c.name: c.launches for c in counters}
        want = cpu_attention(*(x.float() for x in (q, k, v)))
        rtol, atol = tolerance[dtype]
        err = (got.cpu().float() - want).abs()
        if launches != {c.name: int(c is counter) for c in counters}:
            raise AssertionError(f"C6 {name} at D={head_dim} {dtype}: launches {launches}")
        if got.dtype != dtype or got.shape != q.shape or not torch.isfinite(got).all():
            raise AssertionError(f"C6 {name} at D={head_dim} {dtype}: output malformed")
        if not bool((err <= atol + rtol * want.abs()).all()):
            raise AssertionError(f"C6 {name} at D={head_dim} {dtype}: max err {err.max().item()}")
        emit({"phase": "c6", "case": name, "shape": list(q.shape), "dtype": str(dtype),
              "causal": True, "max_abs_err_vs_cpu": err.max().item(), "rtol": rtol,
              "atol": atol, "kernel_launches": launches})

    config = check_total_timesteps(compose(C6_TRANS, TRANS_ROOT), 1)
    env, _ = envs.make(config)
    setup = ff_trans_ppo.learner_setup(env, config, torch.device("cuda"),
                                       seed=int(config.arch.seed))
    for counter in (*counters, *linear_recurrence.COUNTERS):
        counter.launches = 0
    _, (_, losses) = setup.learn.update_step(setup.learner_state)
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in (*counters, *linear_recurrence.COUNTERS)}
    losses = {key: value.float().mean().item() for key, value in losses.items()}
    if (not launches[fa.FORWARD.name] or not launches[fa.BACKWARD.name]
            or launches[linear_recurrence.GAE_KERNEL.name] != 1):
        raise AssertionError(f"ff_trans_ppo at head_dim 8 launched {launches}")
    if not all(math.isfinite(value) for value in losses.values()):
        raise AssertionError(f"ff_trans_ppo at head_dim 8: non-finite losses {losses}")
    emit({"phase": "c6", "case": "ff_trans_ppo update step", "head_dim": 8,
          "launches": launches, "losses": losses, "card": smi})


C8_WIDTH = 256  # the widest head dim the kernels are built for (C8)


def phase_c8(smi: str) -> dict:
    """Head dims up to 256 run through the kernels on the card (C8): B2's
    forward and backward and B3 at D = 256 in float32, bfloat16 and float16
    against their plain versions; `best_attention` at D = 200 (padded to 256)
    and `TransformerTorso` forward and gradients at D = 256 against the CPU;
    one ff_trans_ppo update at 4 heads x 256 through B2; D = 257 refused; the
    D = 256 forward and backward timed beside their bounds. Returns the
    timing records."""
    fa, fac = flash_attention, flash_attention_chunk
    width = C8_WIDTH
    # As phase attention: float32 1e-5 absolute, bfloat16 2e-2, float16 2e-3;
    # the backward's 16-bit types also relative at those; B3 1e-5 relative to l.
    tolerance = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
    shapes = [((TRANS_ENVS, 16, 4, width), True), ((2, 300, 2, width), True)]
    for seed, ((shape, causal), dtype) in enumerate(
            (case, dtype) for case in shapes for dtype in tolerance):
        q, k, v = qkv_views(*shape, dtype, seed=70 + seed)
        dout = qkv_views(*shape, dtype, seed=90 + seed)[0].contiguous()
        o, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
        grads = fa.backward_kernel(q, k, v, o, lse, dout, causal)
        positions = torch.arange(shape[1], dtype=torch.int32, device="cuda")
        chunk = fac.chunk_kernel(q, k, v, positions, positions, causal)
        torch.cuda.synchronize()
        want_o, want_lse = fa.plain_flash_attention_forward(q, k, v, causal, need_lse=True)
        want_grads = fa.plain_flash_attention_backward(q, k, v, o, lse, dout, causal)
        want_chunk = fac.plain_flash_attention_chunk(q, k, v, positions, positions, causal)
        atol = tolerance[dtype]
        rtol = 0.0 if dtype == torch.float32 else atol
        forward_err = (o.float() - want_o.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        backward_errs = [(g.float() - w.float()).abs().max().item()
                         for g, w in zip(grads, want_grads)]
        chunk_errs = fac.chunk_errors(chunk, want_chunk)
        outputs = (o, *grads, *chunk)
        if any(not torch.isfinite(x).all() for x in outputs) or o.shape != q.shape:
            raise AssertionError(f"C8 kernels' output malformed at {shape} {dtype}")
        if not (forward_err <= atol and lse_err <= 1e-5):
            raise AssertionError(f"C8 forward != plain at {shape} {dtype}: {forward_err}, "
                                 f"lse {lse_err}")
        if not all(bool(((g.float() - w.float()).abs() <= atol + rtol * w.float().abs()).all())
                   for g, w in zip(grads, want_grads)):
            raise AssertionError(f"C8 backward != plain at {shape} {dtype}: {backward_errs}")
        if not max(chunk_errs) <= 1e-5:
            raise AssertionError(f"C8 chunk != plain at {shape} {dtype}: {chunk_errs}")
        emit({"phase": "c8", "case": "kernels", "shape": list(shape), "dtype": str(dtype),
              "causal": causal, "forward_max_abs_err": forward_err, "lse_max_abs_err": lse_err,
              "backward_max_abs_err_dq_dk_dv": backward_errs, "chunk_errors_m_l_pv": chunk_errs,
              "tolerance": atol, "rtol": rtol})

    # Against the CPU (2e-5, the attention tolerance): best_attention at a
    # padded head dim, one forward launch. The torso's forward and gradients
    # at D = 256, one forward and one backward launch: the output at 1e-4, the
    # torso tolerance of phase ring; the gradients at 5e-4 absolute and 1e-4
    # relative, since its 512-wide layers sum in another order on the card
    # (tests/test_torch_cuda.py, the torso at wide head dims).
    q, k, v = qkv_views(64, 16, 4, 200, torch.float32, seed=80)
    for counter in fa.COUNTERS:
        counter.launches = 0
    got = best_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = _counts(fa.COUNTERS)
    err = (got.cpu() - cpu_attention(q, k, v)).abs().max().item()
    if launches != {fa.FORWARD.name: 1, fa.BACKWARD.name: 0} or not err <= 2e-5:
        raise AssertionError(f"C8 best_attention at D=200: launches {launches}, err {err}")
    emit({"phase": "c8", "case": "best_attention", "shape": list(q.shape), "padded_to": width,
          "max_abs_err_vs_cpu": err, "tolerance": 2e-5, "kernel_launches": launches})

    torso = TransformerTorso(5, 1, 2, width, 32, generator=torch.Generator().manual_seed(0))
    x = torch.randn((3, 4, 5), generator=torch.Generator().manual_seed(1))
    want, want_grads = cpu_torso_reference(torso, x)
    for counter in fa.COUNTERS:
        counter.launches = 0
    got = torso.to("cuda")(x.to("cuda"))
    (got ** 2).sum().backward()
    torch.cuda.synchronize()
    launches = _counts(fa.COUNTERS)
    out_err = (got.detach().cpu() - want.detach()).abs().max().item()
    grad_err = max(((p.grad.cpu() - w).abs() - 1e-4 * w.abs()).max().item()
                   for p, w in zip(torso.parameters(), want_grads))
    if launches != {fa.FORWARD.name: 1, fa.BACKWARD.name: 1} or not (out_err <= 1e-4
                                                                    and grad_err <= 5e-4):
        raise AssertionError(f"C8 torso at D=256: launches {launches}, errors {out_err}, "
                             f"{grad_err}")
    emit({"phase": "c8", "case": "transformer_torso", "head_dim": width,
          "max_abs_err_vs_cpu": out_err, "grad_err_past_1e-4_relative": grad_err,
          "tolerance": 1e-4, "grad_tolerance": 5e-4,
          "kernel_launches": launches})

    config = check_total_timesteps(compose([f"system.head_dim={width}", "system.num_heads=4",
                                            "system.multistep_impl=pallas",
                                            "logger.use_console=False"], TRANS_ROOT), 1)
    env, _ = envs.make(config)
    setup = ff_trans_ppo.learner_setup(env, config, torch.device("cuda"),
                                       seed=int(config.arch.seed))
    for counter in fa.COUNTERS:
        counter.launches = 0
    start = time.perf_counter()
    _, (_, losses) = setup.learn.update_step(setup.learner_state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = _counts(fa.COUNTERS)
    layers = int(config.system.num_layers)
    expected = {fa.FORWARD.name: 2 * layers * TRANS["rollout"] + layers
                + 2 * layers * TRANS["epochs"] * TRANS["minibatches"],
                fa.BACKWARD.name: 2 * layers * TRANS["epochs"] * TRANS["minibatches"]}
    losses = {key: value.float().mean().item() for key, value in losses.items()}
    if launches != expected or not all(math.isfinite(value) for value in losses.values()):
        raise AssertionError(f"ff_trans_ppo at head_dim {width}: launches {launches} (expected "
                             f"{expected}), losses {losses}")
    emit({"phase": "c8", "case": "ff_trans_ppo update step", "heads": 4, "head_dim": width,
          "total_num_envs": int(config.arch.total_num_envs), "launches": launches,
          "losses": losses, "seconds": seconds, "card": smi})

    # Times at the path-like shape, float32: a launch (graph replay) and a call.
    times = timed_kernels(NARROW_ROUTE, (TRANS_ENVS, 16, 4, width), 81, smi, "c8_time")
    return {"times": times}


def sdpa_ms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            dout: torch.Tensor) -> dict:
    """SDPA's forward and its backward alone on these inputs, or the error
    that refuses them."""
    try:
        leaf = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        out = sdpa(*leaf, causal)
        return {"forward": cuda_ms(lambda: sdpa(q, k, v, causal)),
                "backward": cuda_ms(lambda: torch.autograd.grad(out, leaf, dout,
                                                                retain_graph=True),
                                    repeats=11, inner=20)}
    except RuntimeError as refused:
        return {"forward": None, "backward": None, "refused": str(refused)}


NARROW_ROUTE = {
    "forward": (flash_attention.forward_kernel, flash_attention.plain_flash_attention_forward),
    "backward": (flash_attention.backward_kernel, flash_attention.plain_flash_attention_backward),
    "chunk": (flash_attention_chunk.chunk_kernel,
              flash_attention_chunk.plain_flash_attention_chunk),
}
WIDE_ROUTE = {
    "forward": (flash_attention_wide.forward_kernel, flash_attention_wide.plain_wide_forward),
    "backward": (flash_attention_wide.backward_kernel, flash_attention_wide.plain_wide_backward),
    "chunk": (flash_attention_wide.chunk_kernel, flash_attention_wide.plain_wide_chunk),
}


def route_errors(kind: str, got, want, relative_backward: bool) -> tuple:
    """A kernel's largest |kernel - plain| over its outputs, and whether it
    holds (`timed_kernels`): the forward's output and lse within 1e-5; the
    backward's dQ, dK, dV within 1e-5 or, with `relative_backward` (the wide
    route's gradients reach tens), 1e-5 of the tensor's largest (at least 1);
    the chunk's `chunk_errors` (m absolute, l and pv relative to l) within
    1e-5."""
    abs_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    if kind == "chunk":
        return abs_err, max(flash_attention_chunk.chunk_errors(got, want)) <= 1e-5
    scale = max(1.0, *(w.abs().max().item() for w in want)) if (
        kind == "backward" and relative_backward) else 1.0
    return abs_err, abs_err <= 1e-5 * scale


def timed_kernels(route: dict, shape, seed: int, smi: str, phase: str,
                  relative_backward: bool = False) -> list:
    """A route's forward, backward and chunk kernels (`NARROW_ROUTE`,
    `WIDE_ROUTE`: each kind's kernel and plain version) at one float32 causal
    shape: first each held against its plain version on the same inputs
    (`route_errors`), then timed: a call, a launch replayed from a CUDA
    graph, the plain version, the bound and SDPA (forward; backward alone; B3
    has none)."""
    causal = True
    q, k, v = qkv_views(*shape, torch.float32, seed=seed)
    dout = qkv_views(*shape, torch.float32, seed=seed + 1)[0].contiguous()
    o, lse = route["forward"][0](q, k, v, causal, need_lse=True)
    positions = torch.arange(shape[1], dtype=torch.int32, device="cuda")
    args = {"forward": (q, k, v, causal), "backward": (q, k, v, o, lse, dout, causal),
            "chunk": (q, k, v, positions, positions, causal)}
    errors = {}
    for kind, (kernel, plain) in route.items():
        extra = {"need_lse": True} if kind == "forward" else {}
        got = kernel(*args[kind], **extra)
        torch.cuda.synchronize()
        want = plain(*args[kind], **extra)
        if any(not torch.isfinite(x).all() for x in got):
            raise AssertionError(f"{phase}: {kind} kernel's output malformed at {shape}")
        errors[kind], held = route_errors(kind, got, want, relative_backward)
        if not held:
            raise AssertionError(f"{phase}: {kind} kernel != plain at {shape}: {errors[kind]}")
        del got, want
    library = sdpa_ms(q, k, v, causal, dout)
    times = []
    for kind, (kernel, plain) in route.items():
        if kind == "chunk":
            bound_ms, bound_by, moved, flops = chunk_bound(q, k, positions, positions, causal)
        else:
            bound_ms, bound_by, moved, flops = attention_bound(kind, q, causal)
        record = {"phase": phase, "kernel": kind, "shape": list(shape), "dtype": "torch.float32",
                  "causal": causal, "max_abs_err": errors[kind],
                  "backward_tolerance_relative": relative_backward,
                  "ms": cuda_ms(lambda: kernel(*args[kind])),
                  "device_ms": graph_ms(lambda: kernel(*args[kind])),
                  "plain_ms": cuda_ms(lambda: plain(*args[kind]), repeats=5, inner=3),
                  "library_ms": library.get(kind), "bound_ms": bound_ms, "bound_by": bound_by,
                  "bytes": moved, "flops": flops, "card": smi}
        if "refused" in library and kind != "chunk":
            record["library_refused"] = library["refused"]
        times.append(record)
        emit(record)
    return times


# Rows that are not whole 16-byte pieces; 6 chunks; the widest one-slice head
# dim; two 512-column output slices, the second one column wide; 16 chunks.
WIDE_DIMS = (257, 384, 512, 513, 1000)
WIDE_TRANS = dict(heads=2, head_dim=512)  # phase c8_wide's ff_trans_ppo update


def phase_c8_wide(mesh, smi: str) -> list:
    """Head dims past 256 run through the wide kernels (C8): each against its
    plain version at D = 257, 384, 512, 513 and 1000 (both sides of the
    512-column slice boundary) in three dtypes, causal and not; `best_attention`
    at D = 257 and the torso's forward and gradients at D = 384 against the
    CPU; then the two paths the kernels serve, each with every counter zeroed
    just before and read just after: one ff_trans_ppo update at 2 heads x 512
    (wide forward and backward) and a one-rank ring over [64, 128, 2, 384]
    (wide chunk); then, at the update's minibatch shape [4096, 16, 2, D] for
    D = 384 and 512, each against its plain version and timed. Returns the
    three kernels-line entries, at D = 512."""
    fa, wide = flash_attention, flash_attention_wide
    counters = (*fa.COUNTERS, flash_attention_chunk.KERNEL, *wide.COUNTERS)
    tolerance = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}
    errors = {"forward": 0.0, "backward": 0.0, "chunk": 0.0}
    cases = [(d, dtype, causal) for d in WIDE_DIMS for dtype in tolerance
             for causal in (True, False)]
    for seed, (d, dtype, causal) in enumerate(cases):
        q, k, v = qkv_views(4, 40, 2, d, dtype, seed=100 + seed)
        dout = qkv_views(4, 40, 2, d, dtype, seed=200 + seed)[0].contiguous()
        q_pos = torch.arange(24, 64, dtype=torch.int32, device="cuda")
        k_pos = torch.randperm(40, generator=torch.Generator().manual_seed(seed)).to(
            device="cuda", dtype=torch.int32)
        o, lse = wide.forward_kernel(q, k, v, causal, need_lse=True)
        grads = wide.backward_kernel(q, k, v, o, lse, dout, causal)
        chunk = wide.chunk_kernel(q, k, v, q_pos, k_pos, causal)
        torch.cuda.synchronize()
        want_o, want_lse = wide.plain_wide_forward(q, k, v, causal, need_lse=True)
        want_grads = wide.plain_wide_backward(q, k, v, o, lse, dout, causal)
        want_chunk = wide.plain_wide_chunk(q, k, v, q_pos, k_pos, causal)
        tol = tolerance[dtype]
        forward_err = (o.float() - want_o.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        # The gradients reach tens: float32 within 1e-5 of the largest (at
        # least 1), the 16-bit types also relative at their tolerance.
        backward_errs = [((g.float() - w.float()).abs().max()
                          / max(1.0, w.float().abs().max().item())).item()
                         for g, w in zip(grads, want_grads)]
        rtol = 0.0 if dtype == torch.float32 else tol
        held = all(bool(((g.float() - w.float()).abs() <= tol * max(1.0, w.float().abs().max()
                                                                    .item())
                         + rtol * w.float().abs()).all()) for g, w in zip(grads, want_grads))
        chunk_errs = flash_attention_chunk.chunk_errors(chunk, want_chunk)
        if any(not torch.isfinite(x).all() for x in (o, *grads, *chunk)):
            raise AssertionError(f"wide kernels' output malformed at D={d} {dtype} {causal}")
        if not (forward_err <= tol and lse_err <= 1e-5 and held and max(chunk_errs) <= 1e-5):
            raise AssertionError(f"wide kernels != plain at D={d} {dtype} causal={causal}: "
                                 f"forward {forward_err}, lse {lse_err}, backward "
                                 f"{backward_errs}, chunk {chunk_errs}")
        if dtype == torch.float32:
            errors = {"forward": max(errors["forward"], forward_err),
                      "backward": max(errors["backward"], *(
                          (g - w).abs().max().item() for g, w in zip(grads, want_grads))),
                      "chunk": max(errors["chunk"], *chunk_errs)}
        emit({"phase": "c8_wide", "case": "kernels", "shape": [4, 40, 2, d], "dtype": str(dtype),
              "causal": causal, "forward_max_abs_err": forward_err, "lse_max_abs_err": lse_err,
              "backward_err_of_largest_dq_dk_dv": backward_errs,
              "chunk_errors_m_l_pv": chunk_errs, "tolerance": tol, "rtol": rtol})

    # best_attention at D = 257: one wide forward launch, nothing narrow; 2e-5 of the CPU.
    q, k, v = qkv_views(64, 16, 2, 257, torch.float32, seed=300)
    for counter in counters:
        counter.launches = 0
    got = best_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = _counts(counters)
    err = (got.cpu() - cpu_attention(q, k, v)).abs().max().item()
    if launches != {**dict.fromkeys(launches, 0), wide.FORWARD.name: 1} or not err <= 2e-5:
        raise AssertionError(f"best_attention at D=257: launches {launches}, err {err}")
    emit({"phase": "c8_wide", "case": "best_attention", "shape": list(q.shape),
          "max_abs_err_vs_cpu": err, "tolerance": 2e-5, "kernel_launches": launches})

    # The torso at D = 384 (tolerances of phase c8's torso).
    torso = TransformerTorso(5, 1, 2, 384, 32, generator=torch.Generator().manual_seed(0))
    x = torch.randn((3, 4, 5), generator=torch.Generator().manual_seed(1))
    want, want_grads = cpu_torso_reference(torso, x)
    for counter in counters:
        counter.launches = 0
    got = torso.to("cuda")(x.to("cuda"))
    (got ** 2).sum().backward()
    torch.cuda.synchronize()
    launches = _counts(counters)
    out_err = (got.detach().cpu() - want.detach()).abs().max().item()
    grad_err = max(((p.grad.cpu() - w).abs() - 1e-4 * w.abs()).max().item()
                   for p, w in zip(torso.parameters(), want_grads))
    expected = {**dict.fromkeys(launches, 0), wide.FORWARD.name: 1, wide.BACKWARD.name: 1}
    if launches != expected or not (out_err <= 1e-4 and grad_err <= 5e-4):
        raise AssertionError(f"torso at D=384: launches {launches}, errors {out_err}, {grad_err}")
    emit({"phase": "c8_wide", "case": "transformer_torso", "head_dim": 384,
          "max_abs_err_vs_cpu": out_err, "grad_err_past_1e-4_relative": grad_err,
          "tolerance": 1e-4, "grad_tolerance": 5e-4, "kernel_launches": launches})

    # Path 1: ff_trans_ppo's update at 2 heads x 512 (d_model 1024).
    config = check_total_timesteps(compose([
        f"system.head_dim={WIDE_TRANS['head_dim']}", f"system.num_heads={WIDE_TRANS['heads']}",
        "system.multistep_impl=pallas", "logger.use_console=False"], TRANS_ROOT), 1)
    env, _ = envs.make(config)
    setup = ff_trans_ppo.learner_setup(env, config, torch.device("cuda"),
                                       seed=int(config.arch.seed))
    for counter in counters:
        counter.launches = 0
    start = time.perf_counter()
    _, (_, losses) = setup.learn.update_step(setup.learner_state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    update_launches = _counts(counters)
    layers = int(config.system.num_layers)
    expected = {**dict.fromkeys(update_launches, 0),
                wide.FORWARD.name: 2 * layers * TRANS["rollout"] + layers
                + 2 * layers * TRANS["epochs"] * TRANS["minibatches"],
                wide.BACKWARD.name: 2 * layers * TRANS["epochs"] * TRANS["minibatches"]}
    losses = {key: value.float().mean().item() for key, value in losses.items()}
    if update_launches != expected or not all(math.isfinite(x) for x in losses.values()):
        raise AssertionError(f"ff_trans_ppo at {WIDE_TRANS}: launches {update_launches} "
                             f"(expected {expected}), losses {losses}")
    emit({"phase": "c8_wide", "case": "ff_trans_ppo update step", **WIDE_TRANS,
          "total_num_envs": int(config.arch.total_num_envs), "launches": update_launches,
          "losses": losses, "seconds": seconds, "card": smi})
    del setup

    # Path 2: the one-rank ring at D = 384, one wide chunk launch, 2e-5 of the CPU.
    q, k, v = qkv_views(RING_BATCH, 128, 2, 384, torch.float32, seed=301)
    for counter in counters:
        counter.launches = 0
    got = ring_attention(q, k, v, mesh.get_group("data"), causal=True)
    torch.cuda.synchronize()
    ring_launches = _counts(counters)
    err = (got.cpu() - cpu_attention(q, k, v)).abs().max().item()
    if ring_launches != {**dict.fromkeys(ring_launches, 0), wide.CHUNK.name: 1} or not err <= 2e-5:
        raise AssertionError(f"one-rank ring at D=384: launches {ring_launches}, err {err}")
    emit({"phase": "c8_wide", "case": "one-rank ring", "shape": list(q.shape),
          "max_abs_err_vs_cpu": err, "tolerance": 2e-5, "kernel_launches": ring_launches})

    # Held against the plain versions and timed at the update's minibatch
    # shape (both the forward and the backward run there).
    times = {d: timed_kernels(WIDE_ROUTE, (4 * TRANS_ENVS, 16, WIDE_TRANS["heads"], d), 400 + d,
                              smi, "c8_wide_time", relative_backward=True)
             for d in (384, WIDE_TRANS["head_dim"])}
    entries = []
    for index, (counter, kind, replaces, launches) in enumerate((
            (wide.FORWARD, "forward", ATTENTION_REPLACES, update_launches),
            (wide.BACKWARD, "backward", ATTENTION_REPLACES, update_launches),
            (wide.CHUNK, "chunk", CHUNK_REPLACES, ring_launches))):
        main_time = times[WIDE_TRANS["head_dim"]][index]
        entries.append({
            "name": counter.name, "route": "cuda", "source": WIDE_SOURCE, "replaces": replaces,
            "launches": launches[counter.name],
            **{key: main_time[key] for key in ("shape", "max_abs_err", "ms", "device_ms",
                                                "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "max_abs_err_small_shapes": errors[kind],
            "shapes": [times[d][index] for d in times],
        })
    return entries


# ff_ppo's main-path knobs, all on (phase knobs).
KNOBS = ["system.normalize_observations=true", "system.update_guard=skip",
         "system.fused_update=true", "arch.update_batch_size=2",
         "env.wrapper.use_cached_auto_reset=true", "logger.use_json=true",
         "logger.use_wandb=true", "logger.checkpointing.save_model=true",
         "logger.checkpointing.save_args.max_to_keep=~", "system.multistep_impl=pallas",
         "logger.use_console=False"]


def _saved_state(uid: str, step: int) -> dict:
    """A checkpoint's leaves, as utils/checkpointing.py wrote them."""
    from stoix_tpu_torch.utils import checkpointing

    path = os.path.join("checkpoints", uid, "ff_ppo", str(step), checkpointing.STATE_FILE)
    return torch.load(path, weights_only=True)


def _device_launches(learner, state) -> int:
    """Device kernel launches of one update step, counted by torch.profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        learner.update_step(state)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_knobs(smi: str) -> None:
    """ff_ppo with every main-path knob on at the default config's full width
    (1024 CartPole envs, MLP 256x256, T=16, 4 x 4 minibatches): env-steps/s,
    B1 launches and device launches per update; a resume from window 1
    against the unbroken run, bitwise; a poisoned loss under skip; and
    IdentityGame with the same knobs above 8.0. Checkpoints and logs go to a
    temporary directory."""
    from stoix_tpu_torch.ops import losses

    lr = linear_recurrence
    full = KNOBS + ["arch.num_eval_episodes=16"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_knobs_") as tmp, contextlib.chdir(tmp):
        def run(overrides, uid):
            config = compose(full + [f"logger.checkpointing.save_args.checkpoint_uid={uid}",
                                     f"logger.base_exp_path={tmp}/results", *overrides])
            return ff_ppo.run_experiment(config, device="cuda"), config

        for counter in lr.COUNTERS:
            counter.launches = 0
        start = time.perf_counter()
        final_return, config = run([f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2"],
                                   "unbroken")
        seconds = time.perf_counter() - start
        stats = copy.deepcopy(runner.LAST_RUN_STATS)
        gae_launches = {c.name: c.launches for c in lr.COUNTERS}
        if gae_launches != {lr.KERNEL.name: 0, lr.GAE_KERNEL.name: MAIN_UPDATES}:
            raise AssertionError(f"B1 launched {gae_launches} in {MAIN_UPDATES} updates at "
                                 "update_batch_size=2, not one GAE launch an update")
        steps = int(config.arch.total_timesteps)
        files = sorted(os.path.relpath(path, tmp) for path in glob.glob(
            os.path.join(tmp, "results", "**", "*.json*"), recursive=True))
        if not any(f.endswith("metrics.json") for f in files) or not any(
                f.endswith("wandb-history.jsonl") for f in files):
            raise AssertionError(f"the json and wandb sinks wrote {files}")

        # Resume: window 1 saved by a run of one window, then loaded and continued.
        run([f"arch.num_updates={MAIN_UPDATES // 2}", "arch.num_evaluation=1"], "first")
        run([f"arch.num_updates={MAIN_UPDATES // 2}", "arch.num_evaluation=1",
             "logger.checkpointing.load_model=true",
             "logger.checkpointing.load_args.checkpoint_uid=first"], "resumed")
        unbroken, resumed = _saved_state("unbroken", steps), _saved_state("resumed", steps)
        differ = [key for key, value in unbroken.items() if not (
            torch.equal(value, resumed[key]) if isinstance(value, torch.Tensor) else
            torch.equal(value["generator_state"], resumed[key]["generator_state"])
            if isinstance(value, dict) else value == resumed[key])]
        if unbroken.keys() != resumed.keys() or differ:
            raise AssertionError(f"the resumed run differs from the unbroken one at {differ}")

        # A poisoned loss (NaN, and NaN gradients, at its second call) under skip.
        clip, calls = losses.ppo_clip_loss, {"n": 0}

        def poisoned(*args, **kwargs):
            calls["n"] += 1
            loss = clip(*args, **kwargs)
            return loss * float("nan") if calls["n"] == 2 else loss

        losses.ppo_clip_loss = poisoned
        try:
            run([f"arch.num_updates={MAIN_UPDATES // 2}", "arch.num_evaluation=1"], "poisoned")
        finally:
            losses.ppo_clip_loss = clip
        skipped = runner.LAST_RUN_STATS["resilience"]["skipped_updates"]
        poisoned_state = _saved_state("poisoned", steps // 2)
        finite = all(bool(torch.isfinite(v).all()) for k, v in poisoned_state.items()
                     if k.startswith("params/"))
        if not (skipped > 0 and finite):
            raise AssertionError(f"skip left skipped_updates {skipped}, finite params {finite}")

        learn_return, _ = run(IDENTITY + ["system.rollout_length=16", "system.epochs=4"],
                              "identity")
        if not learn_return > 8.0:
            raise AssertionError(f"IdentityGame with every knob on returned {learn_return}")

        env, _ = envs.make(config)
        setup = ff_ppo.learner_setup(env, config, torch.device("cuda"),
                                     seed=int(config.arch.seed))
        state, _ = setup.learn.update_step(setup.learner_state)  # warm-up
        launches = _device_launches(setup.learn, state)
    emit({"phase": "knobs", "env": "cartpole", "total_num_envs": int(config.arch.total_num_envs),
          "update_batch_size": 2, "updates": MAIN_UPDATES, "knobs": KNOBS,
          "b1_gae_launches_per_update": gae_launches[lr.GAE_KERNEL.name] / MAIN_UPDATES,
          "device_launches_per_update": launches,
          "env_steps_per_second": stats["steps_per_second"],
          "window_seconds": stats["window_seconds"], "final_eval_return": final_return,
          "resume_bitwise": True, "resumed_leaves": len(unbroken),
          "poisoned_skipped_updates": skipped, "poisoned_params_finite": finite,
          "identity_game_return": learn_return, "sink_files": files, "seconds": seconds,
          "card": smi})


# The value-based family: the JAX package's IdentityGame oracles (10.0 on the
# CPU with these overrides); ff_pqn at 32768 steps, where the JAX package
# returns 10.0 on every seed tried (at 16384 it misses 8.0 on two of four).
Q_IDENTITY = ["env=identity_game", "arch.total_num_envs=16", "arch.num_evaluation=1",
              "arch.num_eval_episodes=32", "logger.use_console=False"]
Q_LEARN = {
    "ff_dqn": (ff_dqn, ["arch.total_timesteps=16384", "system.total_buffer_size=4096",
                        "system.total_batch_size=64"]),
    "ff_pqn": (ff_pqn, ["arch.total_timesteps=32768", "system.decay_epsilon=false",
                        "system.num_minibatches=2", "system.multistep_impl=pallas"]),
}
Q_SYSTEMS = {"ff_dqn": ff_dqn, "ff_ddqn": ff_ddqn, "ff_dqn_reg": ff_dqn_reg, "ff_mdqn": ff_mdqn,
             "ff_c51": ff_c51, "ff_qr_dqn": ff_qr_dqn, "ff_pqn": ff_pqn}


def phase_q_learn() -> None:
    for name, (module, overrides) in Q_LEARN.items():
        config = compose(Q_IDENTITY + overrides, f"default/anakin/default_{name}.yaml")
        start = time.perf_counter()
        final_return = module.run_experiment(config, device="cuda")
        if not final_return > 8.0:
            raise AssertionError(f"{name} did not learn IdentityGame on the card: {final_return}")
        emit({"phase": "q_learn", "system": name, "env": "identity_game",
              "final_return": final_return, "seconds": time.perf_counter() - start})


def phase_q_train(smi: str) -> int:
    """ff_dqn and ff_pqn (multistep_impl=pallas) at their default configs'
    full width on CartPole, MAIN_UPDATES updates in 2 eval windows: env-steps/s
    per window and device launches an update (torch.profiler, after a
    warm-up step); B1's counters zeroed just before ff_pqn's run and read
    just after: exactly one generic launch an update, no GAE one. Then the
    other five systems one window each at their default widths, each
    finite. Returns B1 generic's launches in ff_pqn's run."""
    lr = linear_recurrence
    pallas_launches = None
    for name, module in Q_SYSTEMS.items():
        full = name in ("ff_dqn", "ff_pqn")
        config = compose([f"arch.num_updates={MAIN_UPDATES if full else 2}",
                          f"arch.num_evaluation={2 if full else 1}", "arch.num_eval_episodes=16",
                          "system.multistep_impl=pallas", "logger.use_console=False"],
                         f"default/anakin/default_{name}.yaml")
        for counter in lr.COUNTERS:
            counter.launches = 0
        start = time.perf_counter()
        final_return = module.run_experiment(config, device="cuda")
        seconds = time.perf_counter() - start
        b1 = _counts(lr.COUNTERS)
        stats = copy.deepcopy(runner.LAST_RUN_STATS)
        train = [rec for rec in stats["history"] if rec["event"] == "trainer"]
        if not math.isfinite(final_return) or not train or not all(
                math.isfinite(v) for rec in train for k, v in rec.items()
                if k not in ("event", "t", "t_eval")):
            raise AssertionError(f"{name}: non-finite return {final_return} or metrics {train}")
        record = {"phase": "q_train", "system": name, "env": "cartpole",
                  "total_num_envs": int(config.arch.total_num_envs),
                  "rollout_length": int(config.system.rollout_length),
                  "updates": int(config.arch.num_updates), "final_eval_return": final_return,
                  "last_train_metrics": train[-1], "b1_launches": b1,
                  "window_seconds": stats["window_seconds"],
                  "env_steps_per_second": stats["steps_per_second"], "seconds": seconds,
                  "card": smi}
        if name == "ff_pqn":
            pallas_launches = b1[lr.KERNEL.name]
            if b1 != {lr.KERNEL.name: int(config.arch.num_updates), lr.GAE_KERNEL.name: 0}:
                raise AssertionError(f"ff_pqn launched B1 {b1} in {config.arch.num_updates} "
                                     "updates, not one generic launch an update")
            record["b1_generic_launches_per_update"] = pallas_launches / MAIN_UPDATES
        if full:
            config = check_total_timesteps(config, 1)
            env, _ = envs.make(config)
            device, seed = torch.device("cuda"), int(config.arch.seed)
            if name == "ff_pqn":
                setup = ff_pqn.learner_setup(env, config, device, seed)
                state = setup.learner_state
            else:
                setup, warmup = q_family.q_learner_setup(env, config, device, seed,
                                                         ff_dqn.dqn_loss)
                state = warmup(setup.learner_state)
            state, _ = setup.learn.update_step(state)  # warm-up
            record["device_launches_per_update"] = _device_launches(setup.learn, state)
        emit(record)
    return pallas_launches


# ---------------------------------------------------- the continuous PPO family and rec_ppo

CONT_ROOT = "default/anakin/default_ff_ppo_continuous.yaml"
REC_ROOT = "default/anakin/default_rec_ppo.yaml"
# Pendulum's learning oracle, fixed before any card run of these systems by
# scripts/jax_oracle_thresholds.py on the CPU: uniform random actions return
# -1221.52 (4096 episodes); the JAX package's ff_ppo_continuous under these
# overrides returns -247.88 (seeds 1 and 2: -215.59, -127.38); the threshold
# is their midpoint.
PENDULUM = ["arch.total_num_envs=64", "arch.total_timesteps=524288", "arch.num_evaluation=4",
            "arch.num_eval_episodes=32", "arch.evaluation_greedy=True",
            "arch.absolute_metric=False", "system.reward_scale=0.1",
            "system.multistep_impl=pallas", "logger.use_console=False"]
PENDULUM_RANDOM_RETURN, PENDULUM_JAX_RETURN = -1221.5223388671875, -247.8776092529297
PENDULUM_THRESHOLD = (PENDULUM_RANDOM_RETURN + PENDULUM_JAX_RETURN) / 2
# ff_ppo_penalty with adaptive beta: tests/test_ff_ppo.py::test_ppo_penalty_adaptive_kl_beta_runs.
PENALTY_IDENTITY = ["env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=65536",
                    "arch.num_evaluation=1", "arch.num_eval_episodes=32",
                    "arch.absolute_metric=False", "system.rollout_length=16",
                    "system.adaptive_kl_beta=true", "system.kl_target=0.01",
                    "system.multistep_impl=pallas", "logger.use_console=False"]
# rec_ppo's IdentityGame oracle: the JAX package's rec_ppo returns 10.0 under
# these overrides on the CPU (scripts/jax_oracle_thresholds.py).
REC_IDENTITY = ["env=identity_game", "arch.total_num_envs=64", "arch.total_timesteps=32768",
                "arch.num_evaluation=1", "arch.num_eval_episodes=32",
                "arch.evaluation_greedy=True", "arch.absolute_metric=False",
                "system.multistep_impl=pallas", "logger.use_console=False"]


def _finite_run(name: str, final_return: float) -> list:
    """The run's trainer records, after checking they and the return are finite."""
    train = [rec for rec in runner.LAST_RUN_STATS["history"] if rec["event"] == "trainer"]
    if not math.isfinite(final_return) or not train or not all(
            math.isfinite(v) for rec in train for k, v in rec.items()
            if k not in ("event", "t", "t_eval")):
        raise AssertionError(f"{name}: non-finite return {final_return} or metrics {train}")
    return train


def phase_cont_learn() -> None:
    """ff_ppo_penalty with adaptive beta on IdentityGame above 4.0 (the JAX
    package's oracle), then ff_ppo_continuous on Pendulum above the
    threshold fixed beforehand."""
    from stoix_tpu_torch.systems.ppo.anakin import ff_ppo_continuous, ff_ppo_penalty

    for name, module, root, overrides, limit in (
            ("ff_ppo_penalty", ff_ppo_penalty, "default/anakin/default_ff_ppo_penalty.yaml",
             PENALTY_IDENTITY, 4.0),
            ("ff_ppo_continuous", ff_ppo_continuous, CONT_ROOT, PENDULUM, PENDULUM_THRESHOLD)):
        start = time.perf_counter()
        final_return = module.run_experiment(compose(overrides, root), device="cuda")
        if not final_return > limit:
            raise AssertionError(f"{name} returned {final_return}, not above {limit}")
        emit({"phase": "cont_learn", "system": name, "final_return": final_return,
              "threshold": limit, "window_seconds": runner.LAST_RUN_STATS["window_seconds"],
              "seconds": time.perf_counter() - start})


def _b1_path_run(name: str, module, root: str, overrides: list, smi: str,
                 device_launches: bool) -> dict:
    """One system's run with B1's counters zeroed just before and read just
    after: exactly one GAE launch an update and no generic one; finite.
    With `device_launches`, one more update step is profiled after a warm-up."""
    lr = linear_recurrence
    config = compose(overrides, root)
    for counter in lr.COUNTERS:
        counter.launches = 0
    start = time.perf_counter()
    final_return = module.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    b1 = _counts(lr.COUNTERS)
    stats = copy.deepcopy(runner.LAST_RUN_STATS)
    train = _finite_run(name, final_return)
    config = check_total_timesteps(config, 1)
    updates = int(config.arch.num_updates)
    if b1 != {lr.KERNEL.name: 0, lr.GAE_KERNEL.name: updates}:
        raise AssertionError(f"{name} launched B1 {b1} in {updates} updates, not one GAE "
                             "launch an update and no generic one")
    record = {"system": name, "env": config.env.scenario.name,
              "total_num_envs": int(config.arch.total_num_envs),
              "rollout_length": int(config.system.rollout_length),
              "epochs": int(config.system.epochs),
              "num_minibatches": int(config.system.num_minibatches), "updates": updates,
              "head": config.network.actor_network.action_head["_target_"].rsplit(".", 1)[-1],
              "b1_gae_launches_per_update": b1[lr.GAE_KERNEL.name] / updates,
              "b1_generic_launches": b1[lr.KERNEL.name], "final_eval_return": final_return,
              "last_train_metrics": train[-1], "window_seconds": stats["window_seconds"],
              "env_steps_per_second": stats["steps_per_second"], "seconds": seconds,
              "card": smi}
    if device_launches:
        env, _ = envs.make(config)
        setup = module.learner_setup(env, config, torch.device("cuda"), int(config.arch.seed))
        state, _ = setup.learn.update_step(setup.learner_state)  # warm-up
        record["device_launches_per_update"] = _device_launches(setup.learn, state)
    return record


def phase_cont_train(smi: str) -> int:
    """ff_ppo_continuous at its default config's full width (1024 Pendulum
    envs, T=16, 4 x 4 minibatches, MLP 256x256 silu, the tanh-Gaussian head
    on [-2, 2]), MAIN_UPDATES updates in 2 eval windows; then ff_ppo_penalty
    (CartPole, adaptive beta), ff_ppo_penalty_continuous, ff_dpo_continuous
    (4 x 16 minibatches) and ff_ppo_continuous with the Beta and the
    diagonal-Gaussian heads, one window of 2 updates each at their default
    widths. Returns B1's GAE launches in the first run."""
    from stoix_tpu_torch.systems.ppo.anakin import (
        ff_dpo_continuous, ff_ppo_continuous, ff_ppo_penalty, ff_ppo_penalty_continuous,
    )

    common = ["arch.num_eval_episodes=16", "system.multistep_impl=pallas",
              "logger.use_console=False"]
    main_run = [f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2", *common]
    short = ["arch.num_updates=2", "arch.num_evaluation=1", *common]
    beta_head = ("network.actor_network.action_head._target_="
                 "stoix_tpu_torch.networks.heads.BetaDistributionHead")
    runs = [
        ("ff_ppo_continuous", ff_ppo_continuous, CONT_ROOT, main_run, True),
        ("ff_ppo_penalty", ff_ppo_penalty, "default/anakin/default_ff_ppo_penalty.yaml",
         short + ["system.adaptive_kl_beta=true"], False),
        ("ff_ppo_penalty_continuous", ff_ppo_penalty_continuous,
         "default/anakin/default_ff_ppo_penalty_continuous.yaml", short, False),
        ("ff_dpo_continuous", ff_dpo_continuous, "default/anakin/default_ff_dpo_continuous.yaml",
         short, False),
        ("ff_ppo_continuous", ff_ppo_continuous, CONT_ROOT, short + [beta_head], False),
        ("ff_ppo_continuous", ff_ppo_continuous, CONT_ROOT,
         short + ["network=mlp_mvn_continuous"], False),
    ]
    launches = None
    for name, module, root, overrides, full in runs:
        record = _b1_path_run(name, module, root, overrides, smi, device_launches=full)
        if launches is None:
            launches = int(record["b1_gae_launches_per_update"] * record["updates"])
        emit({"phase": "cont_train", **record})
    return launches


def phase_rec_learn() -> None:
    from stoix_tpu_torch.systems.ppo.anakin import rec_ppo

    start = time.perf_counter()
    final_return = rec_ppo.run_experiment(compose(REC_IDENTITY, REC_ROOT), device="cuda")
    if not final_return > 8.0:
        raise AssertionError(f"rec_ppo did not learn IdentityGame on the card: {final_return}")
    emit({"phase": "rec_learn", "env": "identity_game", "final_return": final_return,
          "seconds": time.perf_counter() - start})


def phase_rec_train(smi: str) -> int:
    """rec_ppo at its default config's full width (1024 CartPole envs, T=16,
    GRU 128 between pre- and post-torsos of 128, 4 x 4 minibatches of env
    sequences), MAIN_UPDATES updates in 2 eval windows: one B1 GAE launch an
    update, env-steps/s, device launches an update. Returns B1's GAE
    launches in the run."""
    from stoix_tpu_torch.systems.ppo.anakin import rec_ppo

    record = _b1_path_run("rec_ppo", rec_ppo, REC_ROOT, [
        f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2", "arch.num_eval_episodes=16",
        "system.multistep_impl=pallas", "logger.use_console=False"], smi, device_launches=True)
    emit({"phase": "rec_train", **record})
    return int(record["b1_gae_launches_per_update"] * record["updates"])


# ---------------------------------------------------- sequence replay: ff_rainbow and rec_r2d2

SEQUENCE_ROOTS = {"ff_rainbow": "default/anakin/default_ff_rainbow.yaml",
                  "rec_r2d2": "default/anakin/default_rec_r2d2.yaml"}
SEQUENCE_PHASE = {"ff_rainbow": "rainbow", "rec_r2d2": "r2d2"}
# The IdentityGame oracles, fixed before any card run of these systems by
# scripts/jax_oracle_thresholds.py on the CPU: the JAX package's ff_rainbow
# returns 10.0 (seeds 42 and 1) and its rec_r2d2 8.9875 and 8.9937 under
# these overrides, where uniform random actions return 2.5 (4 actions, 10
# steps); the threshold is the family's 8.0.
SEQUENCE_IDENTITY = {
    "ff_rainbow": ["env=identity_game", "arch.total_num_envs=16", "arch.num_evaluation=1",
                   "arch.num_eval_episodes=32", "arch.total_timesteps=65536",
                   "system.total_buffer_size=4096", "system.total_batch_size=64",
                   "system.vmin=0.0", "system.vmax=10.0", "logger.use_console=False"],
    "rec_r2d2": ["env=identity_game", "arch.total_num_envs=16", "arch.num_evaluation=1",
                 "arch.num_eval_episodes=32", "arch.total_timesteps=131072",
                 "system.total_buffer_size=4096", "system.total_batch_size=16",
                 "logger.use_console=False"],
}
SEQUENCE_THRESHOLD = 8.0


def _sequence_module(name: str):
    from stoix_tpu_torch.systems.q_learning import ff_rainbow, rec_r2d2

    return {"ff_rainbow": ff_rainbow, "rec_r2d2": rec_r2d2}[name]


def _kernel_counters() -> tuple:
    """Every kernel's launch counter: B1's two entry points, B2's forward and
    backward, B3, and the wide route's three."""
    return (*linear_recurrence.COUNTERS, *flash_attention.COUNTERS, flash_attention_chunk.KERNEL,
            *flash_attention_wide.COUNTERS)


def phase_sequence_learn(name: str) -> None:
    """`name` trains IdentityGame on the card above the threshold."""
    start = time.perf_counter()
    final_return = _sequence_module(name).run_experiment(
        compose(SEQUENCE_IDENTITY[name], SEQUENCE_ROOTS[name]), device="cuda")
    if not final_return > SEQUENCE_THRESHOLD:
        raise AssertionError(f"{name} did not learn IdentityGame on the card: {final_return}")
    emit({"phase": f"{SEQUENCE_PHASE[name]}_learn", "system": name, "env": "identity_game",
          "final_return": final_return, "threshold": SEQUENCE_THRESHOLD,
          "window_seconds": runner.LAST_RUN_STATS["window_seconds"],
          "seconds": time.perf_counter() - start})


def _sequence_setup(name: str, config, device: torch.device, seed: int):
    """(the system's setup, its learner state ready to update) on `device`."""
    setup = _sequence_module(name).learner_setup(envs.make(config)[0], config, device, seed)
    if name == "ff_rainbow":  # (setup, its warmup fill)
        setup, warmup = setup
        return setup, warmup(setup.learner_state)
    return setup, setup.learner_state


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _relative(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got.cpu() - want).abs() / want.abs().clamp_min(1e-30)).max())


def _update_on_card_and_cpu(name: str, config, setup, state) -> dict:
    """One update epoch on a PrioritisedSample drawn on the card, run by the
    card's learner and by the same learner built on the CPU, from the same
    params (Rainbow's three noise draws made on the card and given to both):
    the loss 1e-5 relative, the params 1e-5 absolute, the new priorities
    1e-5 relative."""
    cpu = torch.device("cpu")
    cpu_setup, _ = _sequence_setup(name, config, cpu, int(config.arch.seed))
    sample = setup.learn.buffer.sample(state.buffer_state, state.generator)
    params, opt = state.params, state.opt_states
    updates = {"card": setup.learn.update_from_batch, "cpu": cpu_setup.learn.update_from_batch}
    if name == "ff_rainbow":
        draws = [updates["card"].q_apply.draw_noise(state.generator) for _ in range(3)]
        given = {"card": draws, "cpu": tree_map(lambda x: x.cpu(), draws)}
        for side, update in updates.items():
            queue = list(given[side])
            update.q_apply.draw_noise = lambda generator, queue=queue: queue.pop(0)
    out = {}
    for side, update in updates.items():
        move = (lambda x: x) if side == "card" else (lambda x: x.cpu())
        out[side] = update([tree_map(move, params)], [tree_map(move, opt)],
                           [tree_map(move, sample)], [None])
    (card_params, _, card_info, card_prio), (cpu_params, _, cpu_info, cpu_prio) = (
        out["card"], out["cpu"])
    loss_err = _relative(card_info["q_loss"], cpu_info["q_loss"])
    param_err = max(float((a.cpu() - b).abs().max()) for side in (0, 1)
                    for a, b in zip(card_params[0][side].values(), cpu_params[0][side].values()))
    prio_err = _relative(card_prio[0], cpu_prio[0])
    if not (loss_err <= 1e-5 and param_err <= 1e-5 and prio_err <= 1e-5):
        raise AssertionError(f"{name}'s update on the card is not the CPU's: loss {loss_err}, "
                             f"params {param_err}, priorities {prio_err}")
    return {"loss_relative_err": loss_err, "params_abs_err": param_err,
            "priorities_relative_err": prio_err, "sample_batch": int(sample.indices.shape[0])}


def _set_priorities_on_card(buffer, state, exponent: float) -> dict:
    """`set_priorities` on the card, twice from the same table, on indices with
    duplicates: bitwise equal both times; on the card and on the CPU every
    written entry is, bitwise, that device's (|p| + 1e-6) ** a of the LAST
    occurrence of its index, and the rest of the table is untouched; the two
    devices agree to 1e-6 relative (their `pow` may round an ulp apart)."""
    priorities = state.buffer_state.priorities
    rows, slots = priorities.shape
    gen = torch.Generator().manual_seed(7)
    indices = torch.stack([torch.randint(0, rows, (4096,), generator=gen),
                           torch.randint(0, min(slots, 8), (4096,), generator=gen)], -1)
    values = torch.randn(4096, generator=gen)
    last = {}  # (row, slot) -> the position of its last occurrence
    for position, (row, slot) in enumerate(indices.tolist()):
        last[(row, slot)] = position
    written = torch.tensor(list(last.keys()))
    positions = torch.tensor(list(last.values()))
    results = []
    for device in ("cuda", "cuda", "cpu"):
        table = state.buffer_state._replace(priorities=priorities.clone().to(device))
        out = buffer.set_priorities(table, indices.to(device), values.to(device)).priorities
        # The same elementwise power over the same vector (a CPU `pow` may
        # round a vector lane and a scalar tail apart), then each index's
        # last occurrence.
        powered = torch.pow(values.to(device).abs() + 1e-6, exponent)
        want = priorities.clone().to(device)
        want[written[:, 0], written[:, 1]] = powered[positions.to(device)]
        if not torch.equal(out, want):
            raise AssertionError(f"set_priorities on {device} did not keep the last occurrence")
        results.append(out.cpu())
    if not torch.equal(results[0], results[1]):
        raise AssertionError("set_priorities on the card differs between two runs")
    across = _relative(results[0], results[2])
    if not across <= 1e-6:
        raise AssertionError(f"set_priorities on the card is {across} from the CPU's")
    return {"indices": 4096, "duplicates": duplicate_indices(indices), "bitwise_twice": True,
            "last_wins_on_card_and_cpu": True, "card_vs_cpu_relative_err": across}


def phase_sequence_train(name: str, smi: str) -> dict:
    """`name` at its default config's full width on CartPole, MAIN_UPDATES
    updates in 2 eval windows through `run_experiment`, every kernel counter
    zeroed just before and read just after (no kernel is on this path:
    every count must stay 0); then, on the same config: device launches an
    update (torch.profiler, after a warm-up step), the duplicate indices that
    `set_priorities` collapsed over two more updates, the buffers' device
    bytes, an update on the card against the CPU, and `set_priorities` on
    the card against itself and the CPU."""
    module = _sequence_module(name)
    config = compose([f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
                      "arch.num_eval_episodes=16", "logger.use_console=False"],
                     SEQUENCE_ROOTS[name])
    counters = _kernel_counters()
    for counter in counters:
        counter.launches = 0
    start = time.perf_counter()
    final_return = module.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    launches = _counts(counters)
    stats = copy.deepcopy(runner.LAST_RUN_STATS)
    train = _finite_run(name, final_return)
    if any(launches.values()):
        raise AssertionError(f"{name} launched kernels {launches}; none is on its path")

    config = check_total_timesteps(config, 1)
    setup, state = _sequence_setup(name, config, torch.device("cuda"), int(config.arch.seed))
    state, _ = setup.learn.update_step(state)  # warm-up
    device_launches = _device_launches(setup.learn, state)
    recorded = []
    buffer = setup.learn.buffer

    def recording(buffer_state, indices, priorities):
        recorded.append(indices.clone())
        return buffer.set_priorities(buffer_state, indices, priorities)

    setup.learn.buffer = buffer._replace(set_priorities=recording)
    for _ in range(2):
        state, _ = setup.learn.update_step(state)
    setup.learn.buffer = buffer
    duplicates = [duplicate_indices(i) for i in recorded]
    record = {
        "phase": f"{SEQUENCE_PHASE[name]}_train", "system": name, "env": "cartpole",
        "total_num_envs": int(config.arch.total_num_envs),
        "rollout_length": int(config.system.rollout_length),
        "epochs": int(config.system.epochs), "updates": MAIN_UPDATES,
        "kernel_launches": launches, "final_eval_return": final_return,
        "last_train_metrics": train[-1], "window_seconds": stats["window_seconds"],
        "env_steps_per_second": stats["steps_per_second"], "seconds": seconds,
        "device_launches_per_update": device_launches,
        "buffer_device_bytes": _tree_bytes(state.buffer_state),
        "priority_slots": list(state.buffer_state.priorities.shape),
        "set_priorities_calls": len(recorded), "duplicate_indices_per_call": duplicates,
        "update_on_card_vs_cpu": _update_on_card_and_cpu(name, config, setup, state),
        "set_priorities_on_card": _set_priorities_on_card(
            buffer, state, float(config.system.priority_exponent)),
        "card": smi,
    }
    emit(record)
    return launches


# ---------------------------------------------------- data parallelism

DP_OVERRIDES = [f"arch.num_updates={MAIN_UPDATES}", "arch.num_evaluation=2",
                "arch.num_eval_episodes=16", "system.multistep_impl=pallas",
                "logger.use_console=False",
                "logger.checkpointing.save_model=true",
                "logger.checkpointing.save_args.max_to_keep=~"]
# ff_ppo's runs fold the observation statistics, so they are reduced too.
DP_PPO = ("ff_ppo", ff_ppo, "default/anakin/default_ff_ppo.yaml",
          ["system.normalize_observations=true"])
DP_PQN = ("ff_pqn", ff_pqn, "default/anakin/default_ff_pqn.yaml", [])
DP_RANKS = 2
REPLICATED = ("params/", "opt_states/", "obs_stats/")


def _distributed(store: str, world: int, rank: int) -> list:
    """The overrides that have the runner form the process group itself."""
    return [f"arch.distributed.coordinator_address=file://{store}",
            f"arch.distributed.num_processes={world}", f"arch.distributed.process_id={rank}"]


def _allreduces() -> dict:
    counter = anakin.allreduce_counter()
    return {kind: counter.value({"kind": kind})
            for kind in ("gradients", "statistics", "kl", "metrics")}


def _dp_run(module, root: str, uid: str, extra: list) -> tuple:
    """One `run_experiment` at DP_OVERRIDES; B1's counters zeroed just before
    and read just after. Returns (record, this rank's saved final state)."""
    lr = linear_recurrence
    config = compose(DP_OVERRIDES + [f"logger.checkpointing.save_args.checkpoint_uid={uid}",
                                     *extra], root)
    for counter in lr.COUNTERS:
        counter.launches = 0
    before = _allreduces()
    start = time.perf_counter()
    final_return = module.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    b1 = _counts(lr.COUNTERS)
    reduces = {k: v - before[k] for k, v in _allreduces().items()}
    stats = copy.deepcopy(runner.LAST_RUN_STATS)
    if not math.isfinite(final_return):
        raise AssertionError(f"{uid}: non-finite eval return {final_return}")
    world = stats["mesh"]["data"]
    step = int(config.arch.total_timesteps)
    name = config.system.system_name
    from stoix_tpu_torch.utils import checkpointing

    rank = dist.get_rank() if dist.is_initialized() else 0
    path = os.path.join("checkpoints", uid, name, str(step),
                        checkpointing.state_file(rank, world))
    updates = int(config.arch.num_updates)
    total_sps = stats["steps_per_second"]
    record = {"system": name, "ranks": world, "envs_per_rank": stats["num_envs_per_rank"],
              "updates": updates, "b1_launches": b1,
              "allreduces_per_update": {k: v / updates for k, v in reduces.items()},
              "expected_gradient_allreduces_per_update":
                  int(config.system.epochs) * int(config.system.num_minibatches),
              "env_steps_per_second_total": total_sps,
              "env_steps_per_second_per_rank": [v / world for v in total_sps],
              "window_seconds": stats["window_seconds"], "final_eval_return": final_return,
              "seconds": seconds}
    return record, torch.load(path, weights_only=True)


def _assert_same(label: str, got: dict, want: dict) -> int:
    """The replicated leaves of two saved states bitwise equal; returns how many."""
    keys = [k for k in want if k.startswith(REPLICATED)]
    if not keys or set(keys) != {k for k in got if k.startswith(REPLICATED)}:
        raise AssertionError(f"{label}: replicated leaves differ in name: {sorted(keys)[:4]}")
    for key in keys:
        if isinstance(want[key], torch.Tensor):
            same = torch.equal(got[key], want[key])
        else:
            same = got[key] == want[key]
        if not same:
            raise AssertionError(f"{label}: {key} differs")
    return len(keys)


def dp_rank(rank: int, world: int, store: str, backend: str, out: str) -> None:
    """One rank of case (b) (`--data-parallel-rank`): the run, then its record
    to `out`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    extra = _distributed(store, world, rank)
    if backend == "gloo":
        # Both ranks on the one card: NCCL refuses two ranks on one device,
        # so the ranks form a gloo group themselves, which the runner keeps.
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                                rank=rank)
        extra = []
    try:
        _, module, root, knobs = DP_PPO
        record, _ = _dp_run(module, root, "dp_two_ranks", knobs + extra)
        record["backend"] = dist.get_backend()
        record["rank"] = dist.get_rank()
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(record, f)


def phase_data_parallel(smi: str) -> dict:
    """Case (a) for ff_ppo and ff_pqn, then case (b); returns B1's launches
    in each run, by case."""
    launches = {}
    for name, module, root, knobs in (DP_PPO, DP_PQN):
        plain, plain_state = _dp_run(module, root, f"dp_{name}_no_group", knobs)
        with tempfile.TemporaryDirectory() as tmp:
            try:
                grouped, grouped_state = _dp_run(
                    module, root, f"dp_{name}_one_rank",
                    knobs + _distributed(os.path.join(tmp, "store"), 1, 0))
                backend = dist.get_backend()
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
        compared = _assert_same(f"{name} one-rank group", grouped_state, plain_state)
        entry = "GAE" if name == "ff_ppo" else "generic"
        kernel = linear_recurrence.GAE_KERNEL if name == "ff_ppo" else linear_recurrence.KERNEL
        for run in (plain, grouped):
            if run["b1_launches"][kernel.name] != run["updates"] or sum(
                    run["b1_launches"].values()) != run["updates"]:
                raise AssertionError(f"{name}: B1 launched {run['b1_launches']} in "
                                     f"{run['updates']} updates, not one {entry} launch each")
        if grouped["allreduces_per_update"]["gradients"] != \
                grouped["expected_gradient_allreduces_per_update"]:
            raise AssertionError(f"{name}: {grouped['allreduces_per_update']} all-reduces an "
                                 "update, not one a minibatch")
        launches[f"a_{name}"] = grouped["b1_launches"][kernel.name]
        emit({"phase": "data_parallel", "case": "a", "backend": backend, **grouped,
              "bitwise_equal_leaves": compared,
              "no_group_env_steps_per_second": plain["env_steps_per_second_total"],
              "card": smi})

    backend = "nccl" if torch.cuda.device_count() >= DP_RANKS else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(DP_RANKS)]
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(DP_RANKS)]
        procs = []
        for rank in range(DP_RANKS):
            with open(logs[rank], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--data-parallel-rank",
                     str(rank), str(DP_RANKS), os.path.join(tmp, "store"), backend, outs[rank]],
                    stdout=log, stderr=subprocess.STDOUT))
        try:
            deadline = time.monotonic() + 600
            while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
                if any(p.returncode for p in procs):
                    break  # one rank failed: the other would wait on it forever
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=60)
        if any(p.returncode for p in procs):
            text = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{open(log).read()[-6000:]}"
                             for r, (p, log) in enumerate(zip(procs, logs)))
            raise AssertionError(f"a data-parallel rank failed:\n{text}")
        records = []
        for out in outs:
            with open(out) as f:
                records.append(json.load(f))
    step = MAIN_UPDATES * int(compose(DP_OVERRIDES).system.rollout_length) * 1024
    from stoix_tpu_torch.utils import checkpointing

    states = [torch.load(os.path.join("checkpoints", "dp_two_ranks", "ff_ppo", str(step),
                                      checkpointing.state_file(r, DP_RANKS)), weights_only=True)
              for r in range(DP_RANKS)]
    compared = _assert_same("two ranks", states[1], states[0])
    gae = linear_recurrence.GAE_KERNEL.name
    for record in records:
        if record["b1_launches"] != {gae: record["updates"], linear_recurrence.KERNEL.name: 0}:
            raise AssertionError(f"rank {record['rank']}: B1 launched {record['b1_launches']} "
                                 f"in {record['updates']} updates, not one GAE launch each")
        if record["allreduces_per_update"]["gradients"] != \
                record["expected_gradient_allreduces_per_update"]:
            raise AssertionError(f"rank {record['rank']}: {record['allreduces_per_update']}")
        if record["envs_per_rank"] != 1024 // DP_RANKS or record["ranks"] != DP_RANKS:
            raise AssertionError(f"rank {record['rank']}: not one {DP_RANKS}-shard run: {record}")
    launches["b_per_rank"] = [record["b1_launches"][gae] for record in records]
    emit({"phase": "data_parallel", "case": "b", "backend": records[0]["backend"],
          "ranks": DP_RANKS, "cards": torch.cuda.device_count(),
          "envs_per_rank": records[0]["envs_per_rank"],
          "allreduces_per_update": records[0]["allreduces_per_update"],
          "expected_gradient_allreduces_per_update":
              records[0]["expected_gradient_allreduces_per_update"],
          "env_steps_per_second_total": records[0]["env_steps_per_second_total"],
          "env_steps_per_second_per_rank": records[0]["env_steps_per_second_per_rank"],
          "b1_gae_launches_per_rank": launches["b_per_rank"], "identical_leaves": compared,
          "final_eval_return": records[0]["final_eval_return"],
          "seconds": [record["seconds"] for record in records], "card": smi})
    return launches


def main() -> None:
    smi = phase_device()
    phase_build()
    recurrence = phase_kernel()
    attention = phase_attention()
    gae, recurrence["composed_path_launches"] = phase_gae()
    phase_learn()
    gae["launches"] = phase_train(smi)
    gae["path"] = "ff_ppo's update, phase train"
    phase_trans_learn()
    trans = phase_trans_train(smi)
    gae["launches_ff_trans_ppo"] = trans["total"][gae["name"]]
    for entry in attention:
        entry["launches"] = trans["total"][entry["name"]]
        entry["learner_launches"] = trans["learner"][entry["name"]]
        entry["evaluator_launches"] = trans["evaluator"][entry["name"]]
    width = ring_width()
    chunk = phase_ring_kernel(width)
    with one_rank_mesh() as mesh:
        ring = phase_ring(width, smi, mesh)
        phase_c6(mesh, smi)
        phase_c8(smi)
        wide = phase_c8_wide(mesh, smi)
    phase_knobs(smi)
    phase_q_learn()
    # The generic entry point is off both PPO paths (their GAE takes the GAE
    # entry point); ff_pqn's Q(lambda) is its training path (phase q_train),
    # and its launches on GAE's composed path (phase gae) stand under their own key.
    recurrence["launches"] = phase_q_train(smi)
    recurrence["path"] = "ff_pqn's update (Q(lambda)), phase q_train"
    phase_cont_learn()
    gae["launches_ff_ppo_continuous"] = phase_cont_train(smi)
    phase_rec_learn()
    gae["launches_rec_ppo"] = phase_rec_train(smi)
    # Sequence replay runs no kernel: each entry records its 0 launches there.
    for name in SEQUENCE_ROOTS:
        phase_sequence_learn(name)
        sequence = phase_sequence_train(name, smi)
        for entry in (recurrence, gae, *attention, chunk, *wide):
            entry.setdefault("launches_sequence_replay", {})[name] = sequence[entry["name"]]
    data_parallel = phase_data_parallel(smi)
    gae["launches_data_parallel"] = {"a_one_rank_ff_ppo": data_parallel["a_ff_ppo"],
                                     "b_per_rank": data_parallel["b_per_rank"]}
    recurrence["launches_data_parallel"] = {"a_one_rank_ff_pqn": data_parallel["a_ff_pqn"]}
    chunk["launches"] = ring["launches"]
    chunk["composed_op"] = {"ring_attention_ms": ring["ring_attention_ms"],
                            "sdpa_ms": ring["sdpa_ms"]}
    kernels = [recurrence, gae, *attention, chunk, *wide]
    if any(entry["launches"] == 0 for entry in kernels):
        raise AssertionError("a kernel of the main path was never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--data-parallel-rank"]:
        dp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
    else:
        main()
