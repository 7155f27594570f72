#!/usr/bin/env python3
"""Variants of B2's fused backward kernel, built from the committed source and
timed side by side on one CUDA card: where its time goes, and what its tuning
constant buys.

    python3 scripts/torch_tune_flash_backward.py [VARIANT ...] [--out PATH]

A VARIANT is a comma-separated list of changes to
stoix_tpu_torch/csrc/flash_attention.cu ("" is the source as committed):

  blocks=N      kBwdMinBlocks = N: the blocks an SM must hold, which caps the
                registers a thread may use
  no_scores     the P and dS phase taken out (the gradients are then wrong)
  no_products   the dV, dK and dQ phase taken out (likewise)

With both phases out, what is left is the copies in and out and the barriers.
Every variant is built with the port's nvcc flags, all at once, and timed per
launch replayed from a CUDA graph at ff_trans_ppo's minibatch shape
[4096, 16, 4, 32] float32 causal, in two rounds (every variant once, then
again). Each result carries its largest difference from the plain backward
and ptxas's registers and spills for the float32 D = 32 instance. Prints one
JSON line per variant and round, and writes them all to --out (default
chiprun_out/tune_flash_backward.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from stoix_tpu_torch.kernels import build  # noqa: E402
from stoix_tpu_torch.kernels import flash_attention as fa  # noqa: E402

SHAPE = (4096, 16, 4, 32)
# Each phase runs from its opening comment to the text that follows it.
PHASES = {
    "no_scores": ("    // P and dS, once per (query, key)", "    // dV += P^T.dO"),
    "no_products": ("    // dV += P^T.dO", "    __syncthreads();\n    if (tiles == 1) {"),
}
MIN_BLOCKS = "constexpr int kBwdMinBlocks = "


def variant_source(source: str, changes: list) -> str:
    for change in changes:
        if change.startswith("blocks="):
            start = source.index(MIN_BLOCKS) + len(MIN_BLOCKS)
            source = source[:start] + change.split("=")[1] + source[source.index(";", start):]
        else:
            first, after = PHASES[change]
            start = source.index(first)
            source = source[:start] + source[source.index(after, start):]
    return source


class VariantLibrary:
    """A built variant, bound as `fa.LIBRARY` is, so `fa.backward_kernel` launches it."""

    def __init__(self, path: str, log: str):
        self.lib, self.log = ctypes.CDLL(path), log
        for name, argtypes in fa.LIBRARY.entries.items():
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        self.lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        self.lib.flash_attention_error_string.restype = ctypes.c_char_p

    def load(self):
        return self.lib

    def check(self, code: int, what: str) -> None:
        if code != 0:
            message = self.lib.flash_attention_error_string(code).decode()
            raise RuntimeError(f"{what} launch failed: {message}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=[""])
    parser.add_argument("--out", default="chiprun_out/tune_flash_backward.json")
    args = parser.parse_args()
    smi = chip_smoke.phase_device()
    work = os.path.join(ROOT, "chiprun_out", "tune_flash_backward")
    os.makedirs(work, exist_ok=True)
    with open(fa.LIBRARY.source) as f:
        committed = f.read()
    builds = []
    for i, variant in enumerate(args.variants):
        source, library = os.path.join(work, f"v{i}.cu"), os.path.join(work, f"v{i}.so")
        with open(source, "w") as f:
            f.write(variant_source(committed, [c for c in variant.split(",") if c]))
        builds.append((library, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", library, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libraries = []
    for library, proc in builds:
        log, _ = proc.communicate(timeout=build.BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {library}:\n{log}")
        libraries.append(VariantLibrary(library, log))

    causal = True
    q, k, v = chip_smoke.qkv_views(*SHAPE, torch.float32, seed=21)
    dout = chip_smoke.qkv_views(*SHAPE, torch.float32, seed=32)[0].contiguous()
    o, lse = fa.forward_kernel(q, k, v, causal, need_lse=True)
    want = fa.plain_flash_attention_backward(q, k, v, o, lse, dout, causal)
    committed_library, results = fa.LIBRARY, []
    try:
        for round_ in range(2):
            for variant, library in zip(args.variants, libraries):
                fa.LIBRARY = library
                run = lambda: fa.backward_kernel(q, k, v, o, lse, dout, causal)  # noqa: E731
                got = run()
                torch.cuda.synchronize()
                ptxas = [{key: x[key] for key in ("registers", "spill_stores", "spill_loads")}
                         for x in chip_smoke.ptxas_instances(
                             [line.strip() for line in library.log.splitlines()
                              if "ptxas info" in line or "spill" in line])
                         if "flash_backward_kernelIfLi32" in x["kernel"]]
                results.append({
                    "variant": variant, "round": round_, "device_ms": chip_smoke.graph_ms(run),
                    "max_abs_err": max((g - w).abs().max().item() for g, w in zip(got, want)),
                    "ptxas_f32_d32": ptxas, "card": smi,
                })
                print(json.dumps(results[-1]), flush=True)
    finally:
        fa.LIBRARY = committed_library
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
