#!/usr/bin/env python3
"""The wide route's kernels (B2's forward and backward and B3 past head dim
256) against an earlier version of them, on one CUDA card, in turns: old,
new, new, old.

    git show a560810:stoix_tpu_torch/csrc/flash_attention_wide.cu > results/wide_old.cu
    python3 scripts/torch_ab_wide_attention.py --old-source results/wide_old.cu \
        [--updates N] [--out PATH]

The old source is commit a560810's `stoix_tpu_torch/csrc/flash_attention_wide.cu` (head
dim streamed 64 columns at a time, accumulators in fp32 work arrays in device
memory, the backward three device kernels), copied into a git-ignored
directory of the checkout such as `results/`. It is built here with the
port's nvcc flags beside the current source and called through its own C
interface (`OldWide`). Both versions are first held against the current plain
versions on the same inputs (`chip_smoke.route_errors`: the forward and B3
within 1e-5, the backward within 1e-5 of its largest gradient; bf16 within
2e-2). Then, in turns, per launch replayed from a CUDA graph (device ms) and
per call from Python (CUDA events):

  * the forward, the backward and B3 at [4096, 16, 2, 512] and
    [4096, 16, 2, 384] (ff_trans_ppo's minibatch at 2 heads of 512 and 384)
    and [1024, 16, 4, 512], float32 and bfloat16, causal, from strided views
    of one fused projection; each beside its byte bound and SDPA's time (a
    yardstick only: the port never calls SDPA);
  * Anakin ff_trans_ppo's learner at 2 heads of 512 (`system.multistep_impl=
    pallas`), every wide forward and backward through one version: N update
    steps a turn (default 2, after one of warm-up) on the host clock, and one
    more under torch.profiler for the device busy ms of an update and the wide
    kernels' share of it.

Prints ptxas's registers and spills for both libraries, one JSON object, and
writes it to --out (default results/ab_wide_attention.json).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
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
from stoix_tpu_torch.kernels import flash_attention_wide as wide  # noqa: E402
from stoix_tpu_torch.kernels.attention_common import DTYPE_CODES  # noqa: E402
from stoix_tpu_torch.ops import scan_kernels  # noqa: E402
from stoix_tpu_torch.systems.ppo.anakin import ff_trans_ppo  # noqa: E402
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps  # noqa: E402
from torch_profile_ppo import _union_us  # noqa: E402

SHAPES = [(4096, 16, 2, 512), (4096, 16, 2, 384), (1024, 16, 4, 512)]
DTYPES = (torch.float32, torch.bfloat16)
TURNS = ("old", "new", "new", "old")
KINDS = ("forward", "backward", "chunk")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE_ARGS = [_P, _I, _I, _I, _I, _F, _I, _P]
OLD_ENTRIES = {  # the old source's C interface
    "flash_attention_wide_forward": [_I] + [_P] * 6 + _SHAPE_ARGS,
    "flash_attention_wide_backward": [_I] + [_P] * 13 + _SHAPE_ARGS,
    "flash_attention_wide_chunk": [_I] + [_P] * 9 + [_I] * 5 + [_F, _I, _P],
}


class OldWide:
    """The old source's three wrapper calls, on its own library: fp32 work arrays for
    the accumulators (the outputs themselves for float32) and a delta
    scratch."""

    def __init__(self, source: str):
        self.library = build.CudaLibrary(os.path.abspath(source), OLD_ENTRIES,
                                         "flash_attention_wide_error_string")

    def _call(self, name, *args):
        self.library.check(getattr(self.library.load(), name)(*args), f"the old {name}")

    @staticmethod
    def _stream():
        return torch.cuda.current_stream().cuda_stream

    def forward_kernel(self, q, k, v, causal=False, need_lse=False, scale=None):
        batch, seq, heads, head_dim = q.shape
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        work = o if q.dtype == torch.float32 else torch.empty(q.shape, dtype=torch.float32,
                                                               device=q.device)
        lse = torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device) \
            if need_lse else None
        self._call("flash_attention_wide_forward", DTYPE_CODES[q.dtype], q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), work.data_ptr(), o.data_ptr(),
                   None if lse is None else lse.data_ptr(), wide._strides(q, k, v), batch, seq,
                   heads, head_dim, wide._scale(head_dim, scale), int(causal), self._stream())
        return o, lse

    def backward_kernel(self, q, k, v, o, lse, dout, causal=False, scale=None):
        batch, seq, heads, head_dim = q.shape
        grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3)]
        works = grads if q.dtype == torch.float32 else [
            torch.empty(q.shape, dtype=torch.float32, device=q.device) for _ in range(3)]
        delta = torch.empty((batch, seq, heads), dtype=torch.float32, device=q.device)
        self._call("flash_attention_wide_backward", DTYPE_CODES[q.dtype], q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), *(x.data_ptr() for x in works),
                   *(x.data_ptr() for x in grads), wide._strides(q, k, v), batch, seq, heads,
                   head_dim, wide._scale(head_dim, scale), int(causal), self._stream())
        return tuple(grads)

    def chunk_kernel(self, q, k, v, q_positions, k_positions, causal=False, scale=None):
        batch, q_len, heads, head_dim = q.shape
        pv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m, l = (torch.empty((batch, heads, q_len), dtype=torch.float32, device=q.device)
                for _ in range(2))
        self._call("flash_attention_wide_chunk", DTYPE_CODES[q.dtype], q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), q_positions.data_ptr(), k_positions.data_ptr(),
                   pv.data_ptr(), m.data_ptr(), l.data_ptr(), wide._strides(q, k, v), batch,
                   q_len, k.shape[1], heads, head_dim, wide._scale(head_dim, scale),
                   int(causal), self._stream())
        return pv, m, l


@contextlib.contextmanager
def through(version):
    """Every wide launch, the dispatch's and autograd's too, goes through
    `version` (an OldWide, or None for the current kernels)."""
    current = {kind: getattr(wide, f"{kind}_kernel") for kind in KINDS}
    if version is not None:
        for kind in KINDS:
            setattr(wide, f"{kind}_kernel", getattr(version, f"{kind}_kernel"))
    try:
        yield
    finally:
        for kind, fn in current.items():
            setattr(wide, f"{kind}_kernel", fn)


def inputs(shape, dtype):
    q, k, v = chip_smoke.qkv_views(*shape, dtype, seed=shape[-1] + shape[0])
    dout = chip_smoke.qkv_views(*shape, dtype, seed=shape[-1] + shape[0] + 1)[0].contiguous()
    o, lse = wide.forward_kernel(q, k, v, True, need_lse=True)
    positions = torch.arange(shape[1], dtype=torch.int32, device="cuda")
    return {"forward": (q, k, v, True), "backward": (q, k, v, o, lse, dout, True),
            "chunk": (q, k, v, positions, positions, True)}


def plain_of(kind):
    return {"forward": wide.plain_wide_forward, "backward": wide.plain_wide_backward,
            "chunk": wide.plain_wide_chunk}[kind]


def check(versions, cases) -> dict:
    """Both versions against the current plain versions, before any timing."""
    errors = {}
    for (shape, dtype), args in cases.items():
        for kind in KINDS:
            extra = {"need_lse": True} if kind == "forward" else {}
            want = plain_of(kind)(*args[kind], **extra)
            for name, version in versions.items():
                with through(version):
                    got = getattr(wide, f"{kind}_kernel")(*args[kind], **extra)
                    torch.cuda.synchronize()
                err, held = chip_smoke.route_errors(kind, got, want, relative_backward=True)
                if dtype != torch.float32 and kind != "chunk":
                    # bf16 outputs: within 2e-2 of each output's largest (at least 1)
                    held = all(bool(((g.float() - w.float()).abs()
                                     <= 2e-2 * max(1.0, w.float().abs().max().item())).all())
                               for g, w in zip(got, want))
                errors[f"{name} {kind} {list(shape)} {dtype}"] = err
                if not held:
                    raise AssertionError(f"{name} {kind} at {shape} {dtype} != plain: {err}")
            del want
    return errors


def kernel_turns(versions, cases) -> list:
    turns = []
    for name in TURNS:
        times = {}
        with through(versions[name]):
            for (shape, dtype), args in cases.items():
                for kind in KINDS:
                    run = partial(getattr(wide, f"{kind}_kernel"), *args[kind])
                    times[f"{kind} {list(shape)} {dtype}"] = {
                        "device_ms": chip_smoke.graph_ms(run),
                        "ms": chip_smoke.cuda_ms(run, repeats=11, inner=20)}
        turns.append({"version": name, "times": times})
    return turns


def update_turns(versions, updates: int) -> dict:
    """ff_trans_ppo update steps at 2 heads of 512, in turns: ms a step on the
    host clock, the device busy ms of one profiled step and the wide kernels'
    device ms in it."""
    config = chip_smoke.compose([
        f"system.head_dim={chip_smoke.WIDE_TRANS['head_dim']}",
        f"system.num_heads={chip_smoke.WIDE_TRANS['heads']}", "system.multistep_impl=pallas",
        "arch.num_updates=100", "arch.num_evaluation=1", "logger.use_console=False"],
        chip_smoke.TRANS_ROOT)
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
            for _ in range(1 if name == "warm-up" else updates):
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
        wide_events = [e for e in events if "wide_" in e.name]
        turns.append({
            "version": name, "update_step_ms": times, "device_busy_ms": busy_ms,
            "wide_device_ms": sum(e.time_range.elapsed_us() for e in wide_events) / 1e3,
            "wide_device_launches": len(wide_events),
            "device_launches": len(events)})
    mean = {name: {key: sum(t[key] for t in turns if t["version"] == name) / 2
                   for key in ("device_busy_ms", "wide_device_ms")}
            for name in ("old", "new")}
    return {"heads": chip_smoke.WIDE_TRANS["heads"], "head_dim": chip_smoke.WIDE_TRANS["head_dim"],
            "turns": turns, "mean": mean,
            "device_busy_saved_ms": mean["old"]["device_busy_ms"] - mean["new"]["device_busy_ms"]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old-source", required=True)
    parser.add_argument("--updates", type=int, default=2)
    parser.add_argument("--out", default="results/ab_wide_attention.json")
    args = parser.parse_args()
    smi = chip_smoke.phase_device()
    old = OldWide(args.old_source)
    versions = {"new": None, "old": old}
    build.build_all([wide.LIBRARY, old.library])
    ptxas = {"new": chip_smoke.ptxas_instances(wide.LIBRARY.ptxas_report()),
             "old": chip_smoke.ptxas_instances(old.library.ptxas_report())}

    cases = {(shape, dtype): inputs(shape, dtype) for shape in SHAPES for dtype in DTYPES}
    errors = check(versions, cases)
    turns = kernel_turns(versions, cases)
    mean = {name: {key: sum(t["times"][key]["device_ms"] for t in turns if t["version"] == name) / 2
                   for key in turns[0]["times"]} for name in versions}
    bounds, library = {}, {}
    for (shape, dtype), case in cases.items():
        q, k, v, o, lse, dout, causal = case["backward"]
        sdpa = chip_smoke.sdpa_ms(q, k, v, causal, dout)
        for kind in KINDS:
            key = f"{kind} {list(shape)} {dtype}"
            if kind == "chunk":
                positions = case["chunk"][3]
                bounds[key] = chip_smoke.chunk_bound(q, k, positions, positions, causal)[:2]
            else:
                bounds[key] = chip_smoke.attention_bound(kind, q, causal)[:2]
            library[key] = sdpa.get(kind)
    report = {
        "card": smi, "causal": True, "old_source": args.old_source, "max_err": errors,
        "kernel_turns": turns, "mean_device_ms": mean,
        "speedup_device": {key: mean["old"][key] / mean["new"][key] for key in mean["new"]},
        "bound_ms": {key: bound[0] for key, bound in bounds.items()},
        "bound_by": {key: bound[1] for key, bound in bounds.items()},
        "times_bound": {name: {key: mean[name][key] / bounds[key][0] for key in mean[name]}
                        for name in mean},
        "sdpa_ms": library,
        "ff_trans_ppo": update_turns(versions, args.updates),
        "ptxas": ptxas,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
