"""Attention dispatch (counterpart of stoix_tpu/ops/pallas_attention.py:
`flash_attention`, `best_attention` and `flash_attention_chunk`).

`flash_attention` is kernel B2 (kernels/flash_attention.py): the hand-written
CUDA kernels on CUDA tensors, with a backward, and their plain versions on CPU
tensors. `best_attention` mirrors the JAX package's dispatch, which sends the
TPU's tensors to its kernel and every other backend's to `full_attention`:
here the card's tensors go to the kernel, and CPU tensors to
`full_attention`. `flash_attention_chunk` is kernel B3
(kernels/flash_attention_chunk.py), ring attention's per-step block. On the
card both run a head dim they are not built for zero-padded to the next one
they are (`kernel_head_dim`, up to 256); past 256 both take the wide route
(kernels/flash_attention_wide.py) on the card and on the CPU.
"""

from __future__ import annotations

import torch

from stoix_tpu_torch.kernels import flash_attention_chunk as chunk
from stoix_tpu_torch.kernels import flash_attention_wide as wide
from stoix_tpu_torch.kernels.flash_attention import (
    flash_attention, kernel_head_dim, pad_head_dim, takes_wide_route,
)
from stoix_tpu_torch.ops.ring_attention import full_attention

__all__ = ["best_attention", "flash_attention", "flash_attention_chunk"]


def best_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """The flash kernels on the card (they launch or raise), plain full
    attention on the CPU; any other device raises."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return full_attention(q, k, v, causal=causal)
    raise ValueError(f"no attention implementation for device {q.device}")


def flash_attention_chunk(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    causal: bool = False,
    block_q: int = 128,
    block_k: int = 128,
):
    """Per-chunk streaming attention for ring composition.

    q: [B, Sq, H, D]; k/v: [B, Sk, H, D]; q_positions [Sq] / k_positions [Sk]
    are GLOBAL sequence positions for causal masking across rotated blocks.
    Returns (pv [B, Sq, H, D] unnormalized fp32, m [B, H, Sq] fp32 running
    max, l [B, H, Sq] fp32 normalizer). Kernel B3 on CUDA tensors (a head
    dim it is not built for zero-padded to `kernel_head_dim`), its plain
    version on CPU tensors; past head dim 256 the wide chunk kernel or its
    plain version. The block sizes must divide the chunk lengths, as
    the JAX package requires; the CUDA kernel's own tiling does not depend on
    them.
    """
    s_q, s_kv = q.shape[1], k.shape[1]
    if s_q % block_q or s_kv % block_k:
        raise ValueError(
            f"block sizes must divide the chunk lengths: got Sq={s_q} vs "
            f"block_q={block_q}, Sk={s_kv} vs block_k={block_k}"
        )
    q_positions = q_positions.to(device=q.device, dtype=torch.int32).contiguous()
    k_positions = k_positions.to(device=q.device, dtype=torch.int32).contiguous()
    if takes_wide_route(q.shape[-1]):
        return wide.wide_flash_attention_chunk(q, k, v, q_positions, k_positions, causal)
    if q.device.type == "cuda":
        head_dim = q.shape[-1]
        width = kernel_head_dim(head_dim)
        if width == head_dim:
            return chunk.chunk_kernel(q, k, v, q_positions, k_positions, causal)
        pv, m, l = chunk.chunk_kernel(*pad_head_dim(width, q, k, v), q_positions, k_positions,
                                      causal, scale=head_dim**-0.5)
        return pv[..., :head_dim], m, l
    if q.device.type == "cpu":
        return chunk.plain_flash_attention_chunk(q, k, v, q_positions, k_positions, causal)
    raise ValueError(f"no flash attention chunk kernel for device {q.device}")
