#!/usr/bin/env python3
"""The error of the wide route's backward (its plain version on the CPU)
against `jax.grad` of the JAX package's `full_attention`, and of both against
a float64 reference, on the inputs of
`tests/test_torch_attention.py::test_wide_route_backward_matches_jax_grad`
(D = 257, 384, 512, 513 and 1000; [2, 40, 2, D] causal and [2, 100, 2, D]
not; the loss sum(o^2)).

    JAX_PLATFORMS=cpu python3 scripts/torch_wide_backward_error.py

Prints one JSON line a case and gradient: the largest |gradient|, the
port's largest error against jax.grad (absolute, and over the largest
|gradient|), and the port's and JAX's largest errors against float64. The
test's tolerance is set from these readings.
"""

from __future__ import annotations

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from stoix_tpu.ops.ring_attention import full_attention as jax_full_attention  # noqa: E402
from stoix_tpu_torch.ops import flash_attention  # noqa: E402

BATCH, HEADS = 2, 2
CASES = ((True, 40), (False, 100))  # (causal, S), as the test takes them


def qkv(seed: int, seq: int, d: int):
    # tests/test_torch_attention.py::_qkv
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(BATCH, seq, HEADS, d)).astype(np.float32) for _ in range(3))


def float64_grads(q, k, v, d: int, causal: bool):
    leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (q, k, v)]
    scores = torch.einsum("bqhd,bkhd->bhqk", leaves[0], leaves[1]) * d**-0.5
    if causal:
        seq = q.shape[1]
        scores = scores.masked_fill(~torch.ones(seq, seq, dtype=torch.bool).tril(), float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), leaves[2])
    (out ** 2).sum().backward()
    return [leaf.grad.numpy() for leaf in leaves]


def main() -> None:
    for d, (causal, seq) in ((d, case) for d in (257, 384, 512, 513, 1000) for case in CASES):
        q, k, v = qkv(d + 2, seq, d)  # the test's seed
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        (flash_attention(*leaves, causal=causal) ** 2).sum().backward()
        want = jax.grad(lambda a, b, c: (jax_full_attention(a, b, c, causal=causal) ** 2).sum(),
                        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        exact = float64_grads(q, k, v, d, causal)
        for name, leaf, w, x in zip(("dq", "dk", "dv"), leaves, want, exact):
            got, w = leaf.grad.numpy(), np.asarray(w)
            largest = float(np.abs(w).max())
            err = float(np.abs(got - w).max())
            print(json.dumps({
                "head_dim": d, "causal": causal, "seq": seq, "grad": name,
                "largest": largest, "port_vs_jax": err,
                "port_vs_jax_over_largest": err / largest,
                "port_vs_float64": float(np.abs(got - x).max()),
                "jax_vs_float64": float(np.abs(w - x).max()),
            }), flush=True)


if __name__ == "__main__":
    main()
