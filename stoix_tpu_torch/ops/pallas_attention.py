"""Attention dispatch (counterpart of stoix_tpu/ops/pallas_attention.py:
`flash_attention` and `best_attention`).

`flash_attention` is kernel B2 (kernels/flash_attention.py): the hand-written
CUDA kernels on CUDA tensors, with a backward, and their plain versions on CPU
tensors. `best_attention` mirrors the JAX package's dispatch, which sends
every backend but the TPU to `full_attention`: here the kernel serves CUDA
tensors and `full_attention` CPU tensors.
"""

from __future__ import annotations

import torch

from stoix_tpu_torch.kernels.flash_attention import flash_attention
from stoix_tpu_torch.ops.ring_attention import full_attention

__all__ = ["best_attention", "flash_attention"]


def best_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """The flash kernel for a CUDA tensor, plain full attention for a CPU
    tensor; any other device raises."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return full_attention(q, k, v, causal=causal)
    raise ValueError(f"no attention implementation for device {q.device}")
