"""What the attention kernels' modules share: the dtype codes the CUDA
entry points take, the launch counter, the row-alignment check, and the plain
PyTorch arithmetic of the online softmax (`fold_key_tiles`) that the plain
versions of B2's forward, B3 and the wide route fold their tiles with
(kernels/flash_attention.py, kernels/flash_attention_chunk.py,
kernels/flash_attention_wide.py), and the exp every plain version takes
(`plain_exp`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

KEY_TILE = 64  # keys folded per online-softmax step past S = 64, as the forward core folds them
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class KernelCounter:
    """Launches of one kernel of the library."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.launches = 0


def check_rows_aligned(what: str, *tensors: torch.Tensor) -> None:
    """The kernels move rows as 16-byte pieces: every tensor's start and its
    batch, seq and head strides must be multiples of 16 bytes."""
    for x in tensors:
        if x.data_ptr() % 16 or any(
            x.stride(i) * x.element_size() % 16 for i in range(3) if x.shape[i] > 1
        ):
            raise ValueError(f"{what} needs 16-byte aligned rows")


def heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> [B, H, S, D] float32."""
    return x.float().permute(0, 2, 1, 3)


def seq_first(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, S, D] float32 -> contiguous [B, S, H, D] in `dtype`."""
    return x.to(dtype).permute(0, 2, 1, 3).contiguous()


def plain_exp(x: torch.Tensor) -> torch.Tensor:
    """torch.exp, on one intra-op thread for a CPU tensor (ROADMAP C11): on
    the H100 machine's host one worker thread's first float32 exp in a
    process has come out about 1e-4 relative off over that thread's whole
    chunk of the tensor (3 of 80 processes at 8 threads), while the same exp
    on the same input rerun, or on one thread, was right. An exp is
    elementwise, so one thread computes the same values."""
    threads = torch.get_num_threads()
    if x.device.type != "cpu" or threads == 1:
        return torch.exp(x)
    torch.set_num_threads(1)
    try:
        return torch.exp(x)
    finally:
        torch.set_num_threads(threads)


def sliced_products(a: torch.Tensor, b: torch.Tensor, parts: Optional[int]) -> torch.Tensor:
    """a @ b^T over the last dim as the wide kernels sum it: `parts` partial
    sums, part i over the 4-column groups g with g % parts == i, added
    pairwise in the order the kernels' shuffles add them
    ((p0 + p1) + (p2 + p3)) + ...; in one product when `parts` is None."""
    if parts is None:
        return a @ b.transpose(-1, -2)
    width = 4 * parts
    pad = -a.shape[-1] % width  # zero columns add exact zeros
    groups = (a.shape[-1] + pad) // width

    def split(x: torch.Tensor) -> torch.Tensor:  # [..., n, D] -> [..., parts, n, 4 * groups]
        x = torch.nn.functional.pad(x, (0, pad)).reshape(*x.shape[:-1], groups, parts, 4)
        return x.movedim(-2, -4).reshape(*x.shape[:-4], parts, x.shape[-4], 4 * groups)

    sa, sb = split(a), split(b)
    partial = [sa[..., i, :, :] @ sb[..., i, :, :].transpose(-1, -2) for i in range(parts)]
    while len(partial) > 1:
        partial = [partial[i] + partial[i + 1] for i in range(0, len(partial), 2)]
    return partial[0]


def fold_key_tiles(
    qs: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
    q_positions: Optional[torch.Tensor] = None, k_positions: Optional[torch.Tensor] = None,
    key_tile: int = KEY_TILE, parts: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' online softmax in plain PyTorch: keys folded `key_tile` at
    a time, as `_fold_block` folds its blocks (the forward core folds one tile
    of all the keys when there are at most KEY_TILE, else tiles of KEY_TILE;
    the wide kernels fold tiles of 16 and sum each score over the head dim in
    `parts` partial sums, `sliced_products`). qs [B, H, Sq, D] float32 (already
    scaled), kf, vf [B, H, Sk, D] float32. Given positions ([Sq] and [Sk]), a
    query sees only the keys at or before its own position (causal). Returns
    m (-inf on a row that saw no key), l [B, H, Sq, 1] and the unnormalised
    acc [B, H, Sq, D]."""
    lead = qs.shape[:-1]
    m = torch.full(lead + (1,), float("-inf"), device=qs.device)
    l = torch.zeros(lead + (1,), device=qs.device)
    acc = torch.zeros_like(qs)
    causal = q_positions is not None
    if causal:
        q_pos = q_positions[:, None]
    for k0 in range(0, kf.shape[2], key_tile):
        k_blk, v_blk = kf[:, :, k0:k0 + key_tile], vf[:, :, k0:k0 + key_tile]
        scores = sliced_products(qs, k_blk, parts)
        mask = None
        if causal:
            mask = q_pos >= k_positions[k0:k0 + key_tile][None]
            scores = torch.where(mask, scores, float("-inf"))
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = plain_exp(scores - m_safe)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        alpha = torch.where(torch.isfinite(m), plain_exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ v_blk
        m = m_new
    return m, l, acc
