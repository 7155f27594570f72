#!/usr/bin/env python3
"""Smoke test of the PyTorch port (stoix_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

  1. device      — needs CUDA; TF32 off for matmuls and convolutions.
  2. build       — builds every kernel from the sources in stoix_tpu_torch/csrc/,
                   one nvcc per source, all started together; prints ptxas's
                   registers, spills and shared memory for every instance of
                   both flash-attention libraries (the forward, the backward
                   and the chunk kernel).
  3. kernel      — B1 (linear recurrence) against its plain PyTorch version on
                   the card, at the main path's shape and at a ragged shape
                   with resets, float32 (bitwise) and bfloat16; timed with CUDA
                   events, per call from Python and per launch replayed from a
                   CUDA graph.
  4. attention   — B2 (flash attention): the forward kernel against its plain
                   version at the ff_trans_ppo path's shapes ([1024|4096|16384,
                   16, 4, 32] float32 causal, from strided qkv views), the ring
                   phase's long window [64, 512, 4, 32] causal, a ragged causal
                   [2, 300, 2, 64], a ragged non-causal [2, 100, 2, 32] and a
                   bfloat16 causal [1, 128, 1, 64], each also run twice and
                   held bitwise equal; the fused backward kernel against the
                   plain backward at [4096, 16, 4, 32] causal, the ragged
                   non-causal [2, 100, 2, 32], [2, 300, 2, 64] causal (five
                   key tiles) and a bfloat16 causal [1, 128, 1, 64]; each
                   kernel timed, beside its plain version and SDPA (forward,
                   backward alone, and both).
  5. gae         — truncation-aware GAE through B1 on the card against the
                   `scan` impl on the CPU, on one rollout-shaped input.
  6. learn       — ff_ppo trains IdentityGame on the card to a return above 8.0
                   (the JAX package's learning oracle, tests/test_ff_ppo.py).
  7. train       — Anakin ff_ppo on CartPole at the default config's full width
                   (1024 envs, T=16, MLP 256x256, 4 epochs x 4 minibatches) for
                   a few updates with system.multistep_impl=pallas; B1's counter
                   is zeroed just before and read just after (once per update).
  8. trans_learn — ff_trans_ppo trains IdentityGame on the card (window 4, one
                   layer) to a return above 8.0.
  9. trans_train — Anakin ff_trans_ppo on CartPole at its default config's full
                   width (1024 envs, T=16, window 16, 2 layers of 4 heads x 32,
                   FFN 256, 4 epochs x 4 minibatches), 4 updates in 2 eval
                   windows with system.multistep_impl=pallas. Every counter is
                   zeroed just before the run and read just after; around each
                   learner call the learner's own launches are counted and must
                   be exact per update: 130 forward, 64 backward, 1 of B1.
                   The evaluator's launches are the rest.
 10. ring_kernel — B3 (flash attention over one K/V chunk) against its plain
                   version on the card: every (rank, step) chunk of a 4-rank
                   causal ring over ff_trans_ppo's transformer at the torso's
                   default window (64 windows of 512, chunks [64, 128, 4, 32]
                   float32 with global positions: future, diagonal and visible
                   chunks), a non-causal chunk, Sq != Sk, a ragged chunk with
                   shuffled key positions and a bfloat16 [1, 128, 1, 64]; the
                   4 ranks' chunks folded as the ring folds them against
                   `full_attention` on the card; each shape timed.
 11. ring        — a one-rank NCCL process group (a `file://` store in a
                   temporary directory) and its mesh; the full-width torso's
                   forward on [64, 512] with ring attention as its attention
                   (exactly one B3 launch per layer, no B2) against the same
                   torso through B2 and through plain attention on the CPU;
                   timed beside the B2 torso and SDPA.

Then a `{"kernels": [...]}` line, the card's `nvidia-smi` name and power
limit, and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import copy
import inspect
import json
import math
import os
import re
import statistics
import subprocess
import tempfile
import time
from functools import partial

import torch
import torch.distributed as dist

from stoix_tpu_torch import envs, parallel
from stoix_tpu_torch.kernels import build, flash_attention, flash_attention_chunk, linear_recurrence
from stoix_tpu_torch.networks.attention import TransformerTorso
from stoix_tpu_torch.ops import truncated_generalized_advantage_estimation
from stoix_tpu_torch.ops.ring_attention import fold_chunk, full_attention, ring_attention
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo, ff_trans_ppo
from stoix_tpu_torch.utils import config as config_lib

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
MAIN_UPDATES = 4
# ff_trans_ppo's default config: layers, heads, head dim, window, rollout, epochs, minibatches.
TRANS = dict(layers=2, heads=4, head_dim=32, window=16, rollout=16, epochs=4, minibatches=4)
TRANS_ENVS = 1024
ATTENTION_SOURCE = "stoix_tpu_torch/csrc/flash_attention.cu"
ATTENTION_REPLACES = "stoix_tpu/ops/pallas_attention.py:154"
CHUNK_SOURCE = "stoix_tpu_torch/csrc/flash_attention_chunk.cu"
CHUNK_REPLACES = "stoix_tpu/ops/pallas_attention.py:255"
RING_BATCH = 64  # windows per forward in the ring phases
RING_RANKS = 4  # the ring the ring_kernel phase emulates


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
    libraries = [linear_recurrence.LIBRARY, flash_attention.LIBRARY, flash_attention_chunk.LIBRARY]
    start = time.perf_counter()
    build.build_all(libraries)
    emit({"phase": "build", "libraries": [lib.library_path() for lib in libraries],
          "seconds": time.perf_counter() - start})
    for library, source in ((flash_attention.LIBRARY, ATTENTION_SOURCE),
                            (flash_attention_chunk.LIBRARY, CHUNK_SOURCE)):
        lines = library.ptxas_report()
        for line in lines:
            print(line, flush=True)
        emit({"phase": "build_ptxas", "library": source, "instances": ptxas_instances(lines)})


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
    # this kernel, tests/test_pallas_attention.py).
    tolerance = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    path = [((b, TRANS["window"], TRANS["heads"], TRANS["head_dim"]), True, torch.float32)
            for b in (TRANS_ENVS, 4 * TRANS_ENVS, TRANS["rollout"] * TRANS_ENVS)]
    errors = {"forward": 0.0, "backward": 0.0}
    long = ((RING_BATCH, 512, TRANS["heads"], TRANS["head_dim"]), True, torch.float32)
    for seed, (shape, causal, dtype) in enumerate(path + [
        long,
        ((2, 300, 2, 64), True, torch.float32),
        ((2, 100, 2, 32), False, torch.float32),
        ((1, 128, 1, 64), True, torch.bfloat16),
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
    # (dQ partials summed) and a bfloat16 one. bfloat16 is also held at 2e-2
    # relative: above 2 a bf16 ulp is 1.6e-2 or more, and the two fp32 sums may
    # round to neighbouring values.
    for seed, (shape, causal, dtype) in enumerate([
        ((4 * TRANS_ENVS, 16, 4, 32), True, torch.float32),
        ((2, 100, 2, 32), False, torch.float32),
        ((2, 300, 2, 64), True, torch.float32),
        ((1, 128, 1, 64), True, torch.bfloat16),
    ]):
        q, k, v = qkv_views(*shape, dtype, seed=10 + seed)
        dout = qkv_views(*shape, dtype, seed=30 + seed)[0].contiguous()
        o, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
        got = fa.backward_kernel(q, k, v, o, lse, dout, causal)
        torch.cuda.synchronize()
        want = fa.plain_flash_attention_backward(q, k, v, o, lse, dout, causal)
        rtol = 0.0 if dtype == torch.float32 else 2e-2
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
    fa = flash_attention
    counters = [fa.FORWARD, fa.BACKWARD, linear_recurrence.KERNEL]
    b1 = "linear_recurrence_reverse"
    layers = TRANS["layers"]
    per_update = {  # the learner's launches in one update step
        fa.FORWARD.name: 2 * layers * TRANS["rollout"] + layers
        + 2 * layers * TRANS["epochs"] * TRANS["minibatches"],
        fa.BACKWARD.name: 2 * layers * TRANS["epochs"] * TRANS["minibatches"],
        b1: 1,
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


def phase_ring(width: dict, smi: str) -> dict:
    """The full-width torso's forward through a one-rank NCCL ring; returns
    B3's launches in that forward and the timings."""
    fa, fac = flash_attention, flash_attention_chunk
    tolerance = 1e-4
    with tempfile.TemporaryDirectory() as tmp:
        config = config_lib.Config.from_dict({"arch": {"distributed": {
            "coordinator_address": "file://" + os.path.join(tmp, "store"),
            "num_processes": 1, "process_id": 0,
        }}})
        parallel.maybe_initialize_distributed(config, device="cuda")
        try:
            mesh = parallel.create_mesh({"data": 1}, device="cuda")
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
            cpu_torso = copy.deepcopy(flash_torso).cpu()  # best_attention: full attention
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
                cpu_out = cpu_torso(x)
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
        finally:
            dist.destroy_process_group()
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


def main() -> None:
    smi = phase_device()
    phase_build()
    recurrence = phase_kernel()
    attention = phase_attention()
    phase_gae()
    phase_learn()
    recurrence["launches"] = phase_train(smi)
    phase_trans_learn()
    trans = phase_trans_train(smi)
    recurrence["launches_ff_trans_ppo"] = trans["total"][recurrence["name"]]
    for entry in attention:
        entry["launches"] = trans["total"][entry["name"]]
        entry["learner_launches"] = trans["learner"][entry["name"]]
        entry["evaluator_launches"] = trans["evaluator"][entry["name"]]
    width = ring_width()
    chunk = phase_ring_kernel(width)
    ring = phase_ring(width, smi)
    chunk["launches"] = ring["launches"]
    chunk["composed_op"] = {"ring_attention_ms": ring["ring_attention_ms"],
                            "sdpa_ms": ring["sdpa_ms"]}
    kernels = [recurrence, *attention, chunk]
    if any(entry["launches"] == 0 for entry in kernels):
        raise AssertionError("a kernel of the main path was never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
