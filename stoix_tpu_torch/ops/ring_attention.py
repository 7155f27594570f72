"""Ring attention: sequence-parallel exact attention over a mesh axis
(counterpart of stoix_tpu/ops/ring_attention.py).

Each process holds one shard of the sequence, [B, S/R, H, D]. The key/value
block starts as the local shard and moves one neighbour round the ring each
step (`torch.distributed` point-to-point sends, where the JAX package uses
`ppermute`), while each process folds its queries' attention to every block
into an fp32 online-softmax accumulator. After R steps each process holds its
queries' exact attention over the whole sequence, and no process ever holds
the whole [S, S] score matrix.

Public API:
    ring_attention(q, k, v, group, causal=False, use_flash=None)  — on the
        rank-local shards of the processes of `group`.
    make_ring_attention(mesh, axis, causal)  — the same, bound to a mesh axis.
    full_attention(q, k, v, causal=False)  — the single-device reference.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


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


def _block_attend(q, k, v, scale, mask: Optional[torch.Tensor]):
    """One K/V block's contribution: returns (scores_max, exp_scores@v,
    exp_scores row-sums) for the online-softmax accumulator."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale  # [B, H, Sq, Sk]
    if mask is not None:
        scores = torch.where(mask, scores, float("-inf"))
    m = scores.amax(-1)  # [B, H, Sq]
    # Guard fully-masked rows: exp(-inf - -inf) would be NaN.
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores - m_safe[..., None])  # [B, H, Sq, Sk]
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)  # [B, Sq, H, D]
    l = p.sum(-1)  # [B, H, Sq]
    return m_safe, pv, l


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: dist.ProcessGroup,
    causal: bool = False,
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """Exact attention with the sequence sharded over the processes of
    `group`, in the order of their ranks in it. Per-process shapes
    [B, S_local, H, D]; returns [B, S_local, H, D] in q.dtype.

    The one deviation from the JAX signature: torch has no ambient mesh axis
    inside which a collective names its axis, so the caller passes the axis's
    process group (`mesh.get_group(axis)`) where the JAX package passes
    `axis_name`.

    The K/V block starts as the local shard and rotates one neighbour per step
    (sent to rank i - 1, received from rank i + 1, the next block in flight
    while this one is folded); after R steps every process has attended to
    every block. For causal masks the block's global offset is derived from
    the rotating source index.

    `use_flash` routes each block's contribution through kernel B3
    (ops/pallas_attention.py::flash_attention_chunk), the same (m, pv, l)
    accumulator contract; True on a CPU tensor runs the kernel's plain
    version. On CUDA the kernel always runs (a head dim it is not built for
    zero-padded up to 256, any wider one through the wide chunk kernel) and
    raises for what it cannot take. B3 is forward only, as the Pallas chunk
    kernel is (ROADMAP C5), so the choice is made from the tensors:

    - None: the kernel for CUDA tensors that need no gradient, the plain
      blocks otherwise; when any of q, k, v requires a gradient (and grad
      mode is on) the plain ring runs under `RingAttention`, whose backward
      is a second ring pass (the JAX package's `use_flash=False` ring, which
      `jax.grad` differentiates through `ppermute`'s transpose);
    - True with a gradient required raises, naming C5;
    - False: the plain blocks, differentiable the same way.
    """
    needs_grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    if use_flash is None:
        use_flash = q.device.type == "cuda" and not needs_grad
    if use_flash and needs_grad:
        raise NotImplementedError(
            "ring_attention(use_flash=True) is forward only: kernel B3, like the Pallas "
            "chunk kernel it ports, has no backward (ROADMAP C5); pass use_flash=None or "
            "False to differentiate the ring")
    if needs_grad:
        return RingAttention.apply(q, k, v, group, causal)
    return _ring_forward(q, k, v, group, causal, use_flash)[0]


def _ring_peers(group: dist.ProcessGroup, my_idx: int, axis_size: int):
    """(the global rank a block is sent to, the one it is received from)."""
    return (dist.get_global_rank(group, (my_idx - 1) % axis_size),
            dist.get_global_rank(group, (my_idx + 1) % axis_size))


def _contiguous(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy, never the caller's tensor (sends need contiguous
    tensors: q, k, v may be strided views of the fused qkv projection)."""
    return x.clone(memory_format=torch.contiguous_format)


def _exchange(sends, recvs, send_to: int, recv_from: int, group, tag: int) -> list:
    """Start sending `sends` to `send_to` and receiving `recvs` from
    `recv_from`, tags from `tag` on; returns the requests to wait on."""
    ops = [dist.P2POp(dist.isend, x, send_to, group, tag=tag + i) for i, x in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, x, recv_from, group, tag=tag + i)
            for i, x in enumerate(recvs)]
    return dist.batch_isend_irecv(ops)


def _causal_mask(my_idx: int, src: int, s: int, device) -> torch.Tensor:
    """[1, 1, Sq, Sk]: query (my_idx's shard) at or after key (src's shard)."""
    local = torch.arange(s, dtype=torch.int32, device=device)
    return ((my_idx * s + local)[:, None] >= (src * s + local)[None, :])[None, None]


def _ring_forward(q, k, v, group, causal: bool, use_flash: bool):
    """The ring's fold: (output in q.dtype, the rows' final max m and
    normaliser l, each [B, H, S] float32)."""
    axis_size = dist.get_world_size(group)
    my_idx = dist.get_rank(group)
    scale = q.shape[-1] ** -0.5
    b, s, h, d = q.shape
    if use_flash:
        # pallas_attention imports this module (full_attention), as in the
        # JAX package: import the chunk kernel's entry point here.
        from stoix_tpu_torch.ops.pallas_attention import flash_attention_chunk

    # Online-softmax accumulators, always fp32.
    m_acc = torch.full((b, h, s), float("-inf"), dtype=torch.float32, device=q.device)
    l_acc = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    o_acc = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)

    local = torch.arange(s, dtype=torch.int32, device=q.device)
    q_pos = my_idx * s + local  # global query positions

    k_blk, v_blk = k, v
    if axis_size > 1:
        # The copies (never the caller's k, v) and a second pair take turns
        # receiving.
        k_blk, v_blk = _contiguous(k), _contiguous(v)
        k_next, v_next = torch.empty_like(k_blk), torch.empty_like(v_blk)
        send_to, recv_from = _ring_peers(group, my_idx, axis_size)

    for r in range(axis_size):
        # The block currently held arrived from rank (my_idx + r) % R.
        src = (my_idx + r) % axis_size
        k_pos = src * s + local
        # Rotate K/V to the next neighbour while this block is folded. The
        # last step's rotation would be discarded: skip the hop.
        pending = []
        if r < axis_size - 1:
            pending = _exchange((k_blk, v_blk), (k_next, v_next), send_to, recv_from, group, 0)
        if use_flash:
            pv_blk, m_blk, l_blk = flash_attention_chunk(
                q, k_blk, v_blk, q_pos, k_pos, causal=causal, block_q=s, block_k=s)
        else:
            mask = _causal_mask(my_idx, src, s, q.device) if causal else None
            m_blk, pv_blk, l_blk = _block_attend(q, k_blk, v_blk, scale, mask)

        m_acc, l_acc, o_acc = fold_chunk((m_acc, l_acc, o_acc), pv_blk, m_blk, l_blk)

        for request in pending:
            request.wait()
        if pending:
            k_blk, k_next = k_next, k_blk
            v_blk, v_next = v_next, v_blk

    # Normalize; fully-masked rows (l == 0) return zeros.
    l_safe = torch.where(l_acc == 0.0, 1.0, l_acc)
    return (o_acc / _bhs_to_bshd(l_safe)).to(q.dtype), m_acc, l_acc


class RingAttention(torch.autograd.Function):
    """The plain ring (`use_flash=False`) with its gradients across ranks.

    Autograd does not cross the ring's sends, so the backward is a ring pass
    of its own: a flash-style backward on the global row statistics. Each
    rank keeps its queries' final max m and normaliser l from the forward,
    so a block's probabilities are recomputed as exp(s - m) / l with no
    second softmax. The K/V blocks rotate as in the forward (contiguous
    copies, the last hop skipped), and each block's dK/dV accumulators
    travel with it: a rank adds its queries' contribution and passes them
    on, and one last hop after the R-th fold brings them home, so every rank
    ends holding the full gradient of its own K/V shard. dQ stays local. All
    of it accumulates in float32 and returns in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        out, m, l = _ring_forward(q, k, v, group, causal, use_flash=False)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, m, l = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        axis_size = dist.get_world_size(group)
        my_idx = dist.get_rank(group)
        s = q.shape[1]
        scale = q.shape[-1] ** -0.5
        qf, dof = q.float(), d_out.float()
        # D_i = rowsum(dO_i * O_i), [B, H, S].
        delta = (dof * out.float()).sum(-1).permute(0, 2, 1)
        inv_l = torch.where(l == 0.0, 0.0, 1.0 / torch.where(l == 0.0, 1.0, l))
        d_q = torch.zeros_like(qf)

        k_blk, v_blk = _contiguous(k.float()), _contiguous(v.float())
        dk_blk, dv_blk = torch.zeros_like(k_blk), torch.zeros_like(v_blk)
        if axis_size > 1:
            k_next, v_next = torch.empty_like(k_blk), torch.empty_like(v_blk)
            dk_next, dv_next = torch.empty_like(dk_blk), torch.empty_like(dv_blk)
            send_to, recv_from = _ring_peers(group, my_idx, axis_size)

        for r in range(axis_size):
            src = (my_idx + r) % axis_size
            pending = []
            if r < axis_size - 1:
                pending = _exchange((k_blk, v_blk), (k_next, v_next), send_to, recv_from,
                                    group, 2)
            scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk) * scale
            p = torch.exp(scores - m[..., None]) * inv_l[..., None]  # [B, H, Sq, Sk]
            if causal:
                p = torch.where(_causal_mask(my_idx, src, s, q.device), p, 0.0)
            d_p = torch.einsum("bqhd,bkhd->bhqk", dof, v_blk)
            d_s = p * (d_p - delta[..., None])
            d_q = d_q + torch.einsum("bhqk,bkhd->bqhd", d_s, k_blk) * scale
            dk_blk = dk_blk + torch.einsum("bhqk,bqhd->bkhd", d_s, qf) * scale
            dv_blk = dv_blk + torch.einsum("bhqk,bqhd->bkhd", p, dof)
            if axis_size > 1:
                # The block's accumulators follow it; after the last fold the
                # hop takes them back to the block's own rank.
                pending += _exchange((dk_blk, dv_blk), (dk_next, dv_next), send_to, recv_from,
                                     group, 4)
            for request in pending:
                request.wait()
            if axis_size > 1:
                dk_blk, dk_next = dk_next, dk_blk
                dv_blk, dv_next = dv_next, dv_blk
                if r < axis_size - 1:
                    k_blk, k_next = k_next, k_blk
                    v_blk, v_next = v_next, v_blk
        return d_q.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype), None, None


def fold_chunk(acc, pv_blk, m_blk, l_blk):
    """Fold one block's (pv, m, l) into the ring's fp32 accumulators
    acc = (m, l, o); returns the new (m, l, o)."""
    m_acc, l_acc, o_acc = acc
    m_new = torch.maximum(m_acc, m_blk)
    # Rescale both accumulators onto the new max.
    alpha = torch.exp(m_acc - m_new)  # old-acc scale
    beta = torch.exp(m_blk - m_new)  # new-block scale
    return (m_new, l_acc * alpha + l_blk * beta,
            o_acc * _bhs_to_bshd(alpha) + pv_blk * _bhs_to_bshd(beta))


def _bhs_to_bshd(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S] -> [B, S, H, 1] for broadcasting against [B, S, H, D]."""
    return x.permute(0, 2, 1)[..., None]


def make_ring_attention(mesh: DeviceMesh, axis: str = "data", causal: bool = False):
    """`ring_attention` bound to the process group of one mesh axis. The
    callable takes and returns the rank-local shards [B, S/R, H, D]: each
    process holds only its own shard of the sequence, in the order of its
    coordinate on `axis`."""
    return partial(ring_attention, group=mesh.get_group(axis), causal=causal)
