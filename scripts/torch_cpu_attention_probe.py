#!/usr/bin/env python3
"""Probe of the host's float32 attention: the port's plain attention on CPU
tensors (the route its CPU runs and CPU parity tests take) against a float64
reference, in many fresh processes, to see whether and when it rounds off.

    python3 scripts/torch_cpu_attention_probe.py [--processes 8] [--parallel 4]

Each process computes `kernels/flash_attention.py::flash_attention` on CPU
tensors three times at [32, 16, 4, 32] causal (ff_trans_ppo's window and
heads) and a float32 batched q.k^T, and reports each one's largest error
against the same arithmetic in float64, and whether the three attentions
are bitwise equal. The inputs are the same values in every process. The
modes separate the suspects:

  file           the inputs loaded from a file, CUDA never initialised;
  file_cuda      the same, with CUDA initialised first;
  file_cuda_1t   the same, on one torch thread;
  file_cuda_nodnn  the same, with oneDNN (mkldnn) off;
  card           the inputs drawn on the card and copied to the host (as the
                 card tests and chip_smoke.py drew them);
  bmm_first      file_cuda, with the batched float32 q.k^T alone as the
                 process's first computation, before any attention (its error
                 is `bmm_error`; past 1e-4 it counts as wrong);
  env_1t         file_cuda, with OMP_NUM_THREADS=1 and MKL_NUM_THREADS=1 in the
                 child's environment (not only torch.set_num_threads(1)).

The modes with CUDA need a card. Prints one JSON line a process and, last, a
JSON summary: per mode, the processes, those whose attention passed 1e-5 of
the float64 reference, those whose batched q.k^T passed 1e-4 of it, and
those whose three attentions differed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (32, 16, 3, 4, 32)  # [B, S, q|k|v, H, D]
SEED = 2
LIMIT = 1e-5
BMM_LIMIT = 1e-4
MODES = ("file", "file_cuda", "file_cuda_1t", "file_cuda_nodnn", "card", "bmm_first", "env_1t")
# The child's environment in each mode, beside the parent's.
ENVIRONMENT = {"env_1t": {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}}


def draw_on_card():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return torch.randn(SHAPE, generator=gen, device="cuda").cpu()


def one_process(mode: str, path: str) -> dict:
    """The probe in this process (`--child`)."""
    import torch

    sys.path.insert(0, REPO)
    from stoix_tpu_torch.kernels import flash_attention as fa

    if mode == "file_cuda_1t":
        torch.set_num_threads(1)
    if mode == "file_cuda_nodnn":
        torch.backends.mkldnn.enabled = False
    if mode != "file":
        torch.cuda.init()
    proj = draw_on_card() if mode == "card" else torch.load(path)
    q, k, v = (proj[:, :, i].contiguous() for i in range(3))
    qs, ks = q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3)

    def bmm_error() -> float:
        return ((qs @ ks.transpose(-1, -2)).double()
                - qs.double() @ ks.double().transpose(-1, -2)).abs().max().item()

    first = bmm_error() if mode == "bmm_first" else None
    want = reference(q, k, v)
    outs = [fa.flash_attention(q, k, v, causal=True) for _ in range(3)]
    errors = [(o.double() - want).abs().max().item() for o in outs]
    bmm = first if first is not None else bmm_error()
    return {"mode": mode, "errors": errors, "repeats_equal": all(torch.equal(o, outs[0])
                                                                 for o in outs),
            "bmm_error": bmm, "bmm_first": first is not None,
            "threads": torch.get_num_threads(), "mkldnn": torch.backends.mkldnn.enabled,
            "environment": {key: os.environ.get(key) for key in ("OMP_NUM_THREADS",
                                                                 "MKL_NUM_THREADS")},
            "address_mod_64": [x.data_ptr() % 64 for x in (q, k, v)],
            "wrong": max(errors) > LIMIT or bmm > BMM_LIMIT}


def reference(q, k, v):
    """Causal softmax attention in float64, [B, S, H, D], independent of the port."""
    import torch

    qd, kd, vd = (x.double().permute(0, 2, 1, 3) for x in (q, k, v))
    scores = qd @ kd.transpose(-1, -2) * q.shape[-1] ** -0.5
    seq = q.shape[1]
    scores = scores.masked_fill(~torch.ones(seq, seq, dtype=torch.bool).tril(), float("-inf"))
    return (scores.softmax(-1) @ vd).permute(0, 2, 1, 3)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--processes", type=int, default=8, help="processes a mode")
    parser.add_argument("--parallel", type=int, default=4, help="processes at once")
    parser.add_argument("--modes", default=",".join(MODES))
    parser.add_argument("--child", nargs=2, metavar=("MODE", "PATH"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(one_process(*args.child)), flush=True)
        return

    import torch

    modes = args.modes.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "proj.pt")
        torch.save(draw_on_card() if torch.cuda.is_available() else
                   torch.randn(SHAPE, generator=torch.Generator().manual_seed(SEED)), path)

        def run(mode: str) -> dict:
            proc = subprocess.run([sys.executable, __file__, "--child", mode, path],
                                  capture_output=True, text=True, timeout=300,
                                  env={**os.environ, **ENVIRONMENT.get(mode, {})})
            if proc.returncode:
                return {"mode": mode, "failed": proc.stderr[-2000:]}
            return json.loads(proc.stdout.strip().splitlines()[-1])

        jobs = [mode for mode in modes for _ in range(args.processes)]
        with ThreadPoolExecutor(args.parallel) as pool:
            results = list(pool.map(run, jobs))
    for record in results:
        print(json.dumps(record), flush=True)
    summary = {mode: {"processes": sum(r["mode"] == mode for r in results),
                      "wrong": sum(r["mode"] == mode and bool(r.get("wrong")) for r in results),
                      "repeats_differ": sum(r["mode"] == mode and r.get("repeats_equal") is False
                                            for r in results),
                      "failed": sum(r["mode"] == mode and "failed" in r for r in results),
                      "bmm_wrong": sum(r["mode"] == mode and r.get("bmm_error", 0.0) > BMM_LIMIT
                                       for r in results),
                      "largest_error": max([max(r["errors"])
                                            for r in results
                                            if r["mode"] == mode and "errors" in r] or [None]),
                      "largest_bmm_error": max([r["bmm_error"] for r in results
                                                if r["mode"] == mode and "bmm_error" in r]
                                               or [None])}
               for mode in modes}
    print(json.dumps({"probe": "cpu_attention", "limit": LIMIT, "bmm_limit": BMM_LIMIT,
                      "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
