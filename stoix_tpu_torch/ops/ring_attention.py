"""Attention without a kernel (counterpart of stoix_tpu/ops/ring_attention.py).

Only `full_attention`, the single-device reference, is ported: the ring itself
(the sequence sharded over devices, K/V blocks rotated between them) waits for
the port's multi-device layer and for kernel B3 (ROADMAP Queue A items 10, 17;
Queue B, B3).
"""

from __future__ import annotations

import torch


def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Plain softmax attention. [B, S, H, D] -> [B, S, H, D]. The scale is
    applied to the scores after QK^T; causal positions are masked with -inf."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)
