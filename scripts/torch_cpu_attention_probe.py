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
                 child's environment (not only torch.set_num_threads(1));
  amax_first, exp_first, pv_first
                 file_cuda (the host's default threads), with one op that the
                 attention runs after q.k^T alone as the process's first
                 computation, on float32 inputs the parent made in float64:
                 the row max of the causal scores (exact against float64),
                 exp of the scores less their row max (1e-6 against float64)
                 or the second product p.v (1e-5 against float64); its error
                 is `first_error`, and past its limit it counts as wrong;
  chain_first    file_cuda (the host's default threads), with the plain
                 forward's own chain on the probe's inputs as the process's
                 first computation, one op at a time, every intermediate
                 kept: q scaled, q.k^T, the causal mask, the row max, exp of
                 the scores less it, the row sum, p.v and the division (the
                 single key tile of `attention_common.fold_key_tiles` at
                 S = 16). Each intermediate is held against the same op in
                 float64 on its own float32 inputs (`step_errors`, each
                 within its limit, STEP_LIMITS) and against the float64
                 chain from the inputs (`chain_errors`); `first_wrong_step`
                 names the first op past its limit. The chain's output must
                 equal the port's attention bitwise, and past LIMIT of the
                 float64 reference the process counts as wrong. When exp is
                 off (`exp_elements`): every element whose float32 exp is past
                 EXP_ELEMENT_LIMIT of exp in float64 on the same float32 input
                 (its flat index, the input, the output, the float64 value, up
                 to KEPT_ELEMENTS of them), the index span, the 8-thread chunk
                 each index falls in (an even split of the flat range) and its
                 lane (index mod 16); then exp rerun on the same input in the
                 same process (bitwise the first? its own error) and on one
                 thread (its error).
  chain_exp_1t   chain_first with only exp run on one torch thread (the
                 thread count set to 1 around it, the host's default around
                 every other op).

Since C11's repair (ROADMAP) the port's plain attention takes its exp on
one thread on the CPU (`kernels/attention_common.py::plain_exp`): the
modes that run the port's attention test the repaired route, while the
chain modes keep the unrepaired chain as the fault's witness.

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
# The ops after q.k^T, each run alone first in its mode: (op, its limit).
FIRST_OPS = {"amax_first": ("amax", 0.0), "exp_first": ("exp", 1e-6), "pv_first": ("pv", 1e-5)}
MODES = ("file", "file_cuda", "file_cuda_1t", "file_cuda_nodnn", "card", "bmm_first", "env_1t",
         *FIRST_OPS, "chain_first", "chain_exp_1t")
CHAIN_MODES = ("chain_first", "chain_exp_1t")
# An exp element counts as wrong past this, against exp in float64 on its own
# float32 input (a correctly rounded float32 exp of x <= 0 is within 6e-8).
EXP_ELEMENT_LIMIT = 1e-6
KEPT_ELEMENTS = 64
# chain_first: each op's limit against the same op in float64 on its float32
# inputs (absolute; the scores are O(10), p and the sums O(1) to O(16)).
STEP_LIMITS = {"scaled_q": 1e-6, "scores": 1e-4, "masked": 0.0, "row_max": 0.0, "exp": 1e-6,
               "row_sum": 1e-5, "pv": 1e-5, "out": 1e-6}
# The child's environment in each mode, beside the parent's.
ENVIRONMENT = {"env_1t": {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}}


def draw_on_card():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return torch.randn(SHAPE, generator=gen, device="cuda").cpu()


def op_inputs(proj):
    """The inputs of the ops after q.k^T, in float32 from float64 arithmetic
    (no float32 product or exp): the masked causal scores [B, H, S, S], the
    scores less their row max, the probabilities and v, heads first."""
    import torch

    q, k, v = (proj[:, :, i].double().permute(0, 2, 1, 3) for i in range(3))
    seq = q.shape[2]
    scores = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    scores = scores.masked_fill(~torch.ones(seq, seq, dtype=torch.bool).tril(), float("-inf"))
    shifted = scores - scores.amax(-1, keepdim=True)
    return {"scores": scores.float(), "shifted": shifted.float(),
            "p": torch.exp(shifted).float(), "v": v.float().contiguous()}


def first_op(op: str, inputs: dict) -> float:
    """The op alone in float32, its largest error against float64."""
    if op == "amax":
        x = inputs["scores"]
        return (x.amax(-1, keepdim=True).double() - x.double().amax(-1, keepdim=True)
                ).abs().max().item()
    if op == "exp":
        x = inputs["shifted"]
        return (x.exp().double() - x.double().exp()).abs().max().item()
    p, v = inputs["p"], inputs["v"]
    return ((p @ v).double() - p.double() @ v.double()).abs().max().item()


def plain_chain(q, k, v, exp_one_thread: bool = False) -> dict:
    """The plain forward's chain for one key tile (`fold_key_tiles` at S <=
    KEY_TILE, then the division), op by op in q's dtype, every
    intermediate kept (exp's input `shifted` and raw output `exp_raw` too).
    With `exp_one_thread` exp alone runs on one torch thread. q, k, v:
    [B, S, H, D]."""
    import torch

    scale = q.shape[3] ** -0.5
    qs = q.permute(0, 2, 1, 3) * scale
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    seq = q.shape[1]
    positions = torch.arange(seq)
    mask = positions[:, None] >= positions[None]
    scores = qs @ kf.transpose(-1, -2)
    masked = torch.where(mask, scores, float("-inf"))
    row_max = torch.maximum(torch.full_like(masked[..., :1], float("-inf")),
                            masked.amax(-1, keepdim=True))
    shifted = masked - row_max
    if exp_one_thread:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        exp_raw = torch.exp(shifted)
        torch.set_num_threads(threads)
    else:
        exp_raw = torch.exp(shifted)
    p = torch.where(mask, exp_raw, 0.0)
    row_sum = p.sum(-1, keepdim=True)
    pv = p @ vf
    out = pv / row_sum
    return {"scaled_q": qs, "scores": scores, "masked": masked, "row_max": row_max,
            "shifted": shifted, "exp_raw": exp_raw, "exp": p, "row_sum": row_sum, "pv": pv,
            "out": out}


def exp_elements(shifted, exp_raw) -> dict:
    """Where the float32 exp is off exp in float64 on the same float32 input:
    the wrong elements (up to KEPT_ELEMENTS), their span, 8-thread chunks and
    lanes; then exp rerun on the same input, with the host's threads and on
    one thread, each held against the first output and float64."""
    import torch

    x = shifted.reshape(-1)
    want = x.double().exp().nan_to_num(0.0)
    error = (exp_raw.reshape(-1).double() - want).abs()
    wrong = torch.nonzero(error > EXP_ELEMENT_LIMIT).reshape(-1)
    n = x.numel()
    chunk = -(-n // 8)
    kept = wrong[:KEPT_ELEMENTS].tolist()
    again = torch.exp(shifted)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    one_thread = torch.exp(shifted)
    torch.set_num_threads(threads)
    span = (int(wrong.min()), int(wrong.max())) if wrong.numel() else None
    return {
        "wrong": int(wrong.numel()), "elements": n,
        "kept": [{"index": i, "input": float(x[i]), "output": float(exp_raw.reshape(-1)[i]),
                  "float64": float(want[i]), "error": float(error[i])} for i in kept],
        "index_span": span,
        "contiguous": bool(wrong.numel()) and span[1] - span[0] + 1 == int(wrong.numel()),
        "chunks_of_8": sorted({i // chunk for i in wrong.tolist()}),
        "lanes_mod_16": sorted({i % 16 for i in wrong.tolist()}),
        "rerun_equals_first": bool(torch.equal(again, exp_raw)),
        "rerun_error": float((again.reshape(-1).double() - want).abs().max()),
        "one_thread_error": float((one_thread.reshape(-1).double() - want).abs().max()),
    }


def chain_probe(q, k, v, exp_one_thread: bool = False) -> dict:
    """`plain_chain` in float32 as the process's first computation, then each
    intermediate against float64: the same op on its float32 inputs (the
    step's own error) and the float64 chain from the inputs; and, when exp
    is off, where (`exp_elements`)."""
    chain = plain_chain(q, k, v, exp_one_thread)  # first: nothing else has run in this process
    whole = plain_chain(q.double(), k.double(), v.double())
    steps = {
        "scaled_q": lambda: q.double().permute(0, 2, 1, 3) * q.shape[3] ** -0.5,
        "scores": lambda: chain["scaled_q"].double() @ k.double().permute(0, 2, 3, 1),
        "masked": lambda: chain["masked"].double(),  # a select: exact
        "row_max": lambda: chain["masked"].double().amax(-1, keepdim=True),
        "exp": lambda: (chain["masked"].double() - chain["row_max"].double()).exp().nan_to_num(
            0.0),
        "row_sum": lambda: chain["exp"].double().sum(-1, keepdim=True),
        "pv": lambda: chain["exp"].double() @ v.double().permute(0, 2, 1, 3),
        "out": lambda: chain["pv"].double() / chain["row_sum"].double(),
    }

    def error(a, b) -> float:
        a, b = a.double(), b.double()
        finite = b.isfinite()
        return float((a[finite] - b[finite]).abs().max()) if bool(finite.any()) else 0.0

    step_errors = {name: error(chain[name], want()) for name, want in steps.items()}
    first_wrong = next((name for name in steps if step_errors[name] > STEP_LIMITS[name]), None)
    out = {"chain_out": chain["out"].permute(0, 2, 1, 3),
           "step_errors": step_errors,
           "chain_errors": {name: error(chain[name], whole[name]) for name in chain},
           "first_wrong_step": first_wrong}
    if step_errors["exp"] > STEP_LIMITS["exp"]:
        out["exp_elements"] = exp_elements(chain["shifted"], chain["exp_raw"])
    return out


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
    op, op_limit = FIRST_OPS.get(mode, (None, None))
    first_op_error = None
    if op is not None:
        first_op_error = first_op(op, torch.load(os.path.join(os.path.dirname(path), "ops.pt")))
    q, k, v = (proj[:, :, i].contiguous() for i in range(3))
    qs, ks = q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3)
    chain = (chain_probe(q, k, v, exp_one_thread=mode == "chain_exp_1t")
             if mode in CHAIN_MODES else None)

    def bmm_error() -> float:
        return ((qs @ ks.transpose(-1, -2)).double()
                - qs.double() @ ks.double().transpose(-1, -2)).abs().max().item()

    first = bmm_error() if mode == "bmm_first" else None
    want = reference(q, k, v)
    outs = [fa.flash_attention(q, k, v, causal=True) for _ in range(3)]
    errors = [(o.double() - want).abs().max().item() for o in outs]
    bmm = first if first is not None else bmm_error()
    chain_fields = {}
    if chain is not None:
        chain_out = chain.pop("chain_out")
        chain_error = (chain_out.double() - want).abs().max().item()
        chain_fields = {**chain, "chain_error": chain_error,
                        "chain_equals_attention": bool(torch.equal(chain_out, outs[0]))}
        errors = [chain_error] + errors
    return {**chain_fields, "mode": mode, "errors": errors,
            "repeats_equal": all(torch.equal(o, outs[0]) for o in outs),
            "bmm_error": bmm, "bmm_first": first is not None,
            "threads": torch.get_num_threads(), "mkldnn": torch.backends.mkldnn.enabled,
            "environment": {key: os.environ.get(key) for key in ("OMP_NUM_THREADS",
                                                                 "MKL_NUM_THREADS")},
            "address_mod_64": [x.data_ptr() % 64 for x in (q, k, v)],
            "first_op": op, "first_error": first_op_error,
            "first_wrong": op is not None and first_op_error > op_limit,
            "wrong": (max(errors) > LIMIT or bmm > BMM_LIMIT
                      or (op is not None and first_op_error > op_limit))}


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
        proj = (draw_on_card() if torch.cuda.is_available() else
                torch.randn(SHAPE, generator=torch.Generator().manual_seed(SEED)))
        torch.save(proj, path)
        torch.save(op_inputs(proj), os.path.join(tmp, "ops.pt"))

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
                      "first_op_wrong": sum(r["mode"] == mode and bool(r.get("first_wrong"))
                                            for r in results),
                      "first_wrong_steps": sorted({r["first_wrong_step"] for r in results
                                                   if r["mode"] == mode
                                                   and r.get("first_wrong_step")}),
                      "exp_wrong_elements": [r["exp_elements"]["wrong"] for r in results
                                             if r["mode"] == mode and "exp_elements" in r],
                      "exp_rerun_equals_first": [r["exp_elements"]["rerun_equals_first"]
                                                 for r in results if r["mode"] == mode
                                                 and "exp_elements" in r],
                      "chain_differs_from_attention": sum(
                          r["mode"] == mode and r.get("chain_equals_attention") is False
                          for r in results),
                      "largest_first_error": max([r["first_error"] for r in results
                                                  if r["mode"] == mode
                                                  and r.get("first_error") is not None]
                                                 or [None]),
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
