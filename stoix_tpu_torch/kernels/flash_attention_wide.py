"""Flash attention past head dim 256: the Hopper CUDA kernels of the wide route
(B2's forward and backward and B3 at any head dim), their plain PyTorch
versions, and the wrappers and autograd function that pick a version by the
tensors' device.

    forward   o = softmax(q * scale . k^T) . v   over [B, S, H, D]
    backward  dq, dk, dv
    chunk     (pv, m, l) of one K/V chunk, masked by global positions (B3)

Replaces, past head dim 256: stoix_tpu/ops/pallas_attention.py::flash_attention
(body `_flash_kernel`) and ::flash_attention_chunk (body `_flash_chunk_kernel`).
Those TPU kernels hold a (batch, head)'s whole [S, D] K and V in VMEM and so
take any head dim VMEM holds; the narrow CUDA kernels (kernels/flash_attention.py,
kernels/flash_attention_chunk.py) hold whole-head-dim tiles in shared memory
and stop at 256. The dispatch (`kernels/flash_attention.py::flash_attention`,
`ops/pallas_attention.py::flash_attention_chunk`) sends every head dim past
HEAD_DIMS[-1] here, on the card and on the CPU.

Bound on an H100: bytes (about 2 flops a byte at S = 16 in float32). The
kernels (csrc/flash_attention_wide.cu) keep their accumulators in registers,
copy 16-byte pieces by cp.async in a ring of stages, and take tiles of 16
query rows (WIDE_ROWS) and 16 keys (WIDE_KEYS) by 64 head-dim columns
(WIDE_CHUNK). A block's outputs cover at most WIDE_SLICE = 512 columns: head
dims up to 512 take one slice; past it the output columns are split into
slices of 512, each recomputing its scores over the whole head dim. The
forward block holds 2 pairs; the backward is one launch (delta, P and dS in
the block) whose block owns a key tile of one pair; with several key tiles a
pair (S > 16) each writes an fp32 dQ partial that `backward_kernel` sums in
tile order. Deterministic, without atomics.

The plain versions fold the same tiles in the same order: each score summed
over the head dim as FORWARD_PARTS (forward, B3) or BACKWARD_PARTS (the
backward's q.k^T and dO.v^T) partial sums added pairwise
(`attention_common.sliced_products`), key tiles of 16 for the online softmax
and dQ, query tiles of 16 for dK and dV.

Counters: FORWARD, BACKWARD and CHUNK each count one entry point's launches
and rise nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from stoix_tpu_torch.kernels.attention_common import (
    DTYPE_CODES, KernelCounter, fold_key_tiles, heads_first, plain_exp, seq_first,
    sliced_products,
)
from stoix_tpu_torch.kernels.build import CudaLibrary

# csrc/flash_attention_wide.cu's kRows, kKeys, kChunk, kSliceChunks * kChunk,
# kFwdParts and kBwdParts.
WIDE_ROWS, WIDE_KEYS, WIDE_CHUNK, WIDE_SLICE = 16, 16, 64, 512
FORWARD_PARTS, BACKWARD_PARTS = 8, 16

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# strides, batch, seq, heads, head_dim, scale, causal, stream
_SHAPE_ARGS = [_P, _I, _I, _I, _I, _F, _I, _P]

LIBRARY = CudaLibrary(
    "flash_attention_wide.cu",
    {
        # dtype, q, k, v, o, lse
        "flash_attention_wide_forward": [_I] + [_P] * 5 + _SHAPE_ARGS,
        # dtype, q, k, v, o, dout, lse, dq, dq_partial, dk, dv
        "flash_attention_wide_backward": [_I] + [_P] * 10 + _SHAPE_ARGS,
        # dtype, q, k, v, q_pos, k_pos, pv, m, l, strides, batch, q_len, k_len,
        # heads, head_dim, scale, causal, stream
        "flash_attention_wide_chunk": [_I] + [_P] * 9 + [_I] * 5 + [_F, _I, _P],
    },
    error_entry="flash_attention_wide_error_string",
)

FORWARD = KernelCounter("flash_attention_wide_forward")
BACKWARD = KernelCounter("flash_attention_wide_backward")
CHUNK = KernelCounter("flash_attention_wide_chunk")
COUNTERS = (FORWARD, BACKWARD, CHUNK)

ChunkResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ----------------------------------------------------------------- plain versions


def plain_wide_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
    need_lse: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The wide forward's arithmetic: o = acc . (1 / l) [B, S, H, D] in
    q.dtype and, if asked, lse [B, H, S] float32 (`scale` defaults to
    D^-1/2)."""
    seq = q.shape[1]
    scale = q.shape[3] ** -0.5 if scale is None else scale
    qs, kf, vf = heads_first(q) * scale, heads_first(k), heads_first(v)
    positions = torch.arange(seq, device=q.device) if causal else None
    m, l, acc = fold_key_tiles(qs, kf, vf, positions, positions, WIDE_KEYS, FORWARD_PARTS)
    o = seq_first(acc * (1.0 / torch.where(l == 0.0, 1.0, l)), q.dtype)
    if not need_lse:
        return o, None
    lse = torch.where(l == 0.0, float("inf"), m + torch.log(l))
    return o, lse[..., 0].contiguous()


def plain_wide_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The wide backward's arithmetic: P = exp(q.scale.K^T - lse) and
    dS = P.(dO V^T - delta), both products as BACKWARD_PARTS partial sums;
    dV and dK summed over query tiles of WIDE_ROWS in order (dK times scale
    at the end), dQ as one partial a key tile of WIDE_KEYS (times scale),
    summed in tile order. Returns dq, dk, dv (contiguous [B, S, H, D],
    q.dtype)."""
    seq = q.shape[1]
    scale = q.shape[3] ** -0.5 if scale is None else scale
    qs, qf, kf, vf = heads_first(q) * scale, heads_first(q), heads_first(k), heads_first(v)
    dof = heads_first(dout)
    delta = (dof * heads_first(o)).sum(-1)
    p = plain_exp(sliced_products(qs, kf, BACKWARD_PARTS) - lse[..., None])
    if causal:
        p = torch.where(torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril(), p, 0.0)
    ds = p * (sliced_products(dof, vf, BACKWARD_PARTS) - delta[..., None])
    dq = dk = dv = None
    for k0 in range(0, seq, WIDE_KEYS):
        part = (ds[..., k0:k0 + WIDE_KEYS] @ kf[:, :, k0:k0 + WIDE_KEYS]) * scale
        dq = part if dq is None else dq + part
    for q0 in range(0, seq, WIDE_ROWS):
        rows = slice(q0, q0 + WIDE_ROWS)
        part_v = p[:, :, rows].transpose(-1, -2) @ dof[:, :, rows]
        part_k = ds[:, :, rows].transpose(-1, -2) @ qf[:, :, rows]
        dv = part_v if dv is None else dv + part_v
        dk = part_k if dk is None else dk + part_k
    return seq_first(dq, q.dtype), seq_first(dk * scale, q.dtype), seq_first(dv, q.dtype)


def plain_wide_chunk(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_positions: torch.Tensor,
    k_positions: torch.Tensor, causal: bool = False, scale: Optional[float] = None,
) -> ChunkResult:
    """The wide chunk kernel's arithmetic: (pv [B, Sq, H, D], m [B, H, Sq],
    l [B, H, Sq]), float32, m = 0 on a row that saw no key."""
    qs = heads_first(q) * (q.shape[3] ** -0.5 if scale is None else scale)
    positions = (q_positions, k_positions) if causal else (None, None)
    m, l, acc = fold_key_tiles(qs, heads_first(k), heads_first(v), *positions,
                               WIDE_KEYS, FORWARD_PARTS)
    m = torch.where(torch.isfinite(m), m, 0.0)
    return acc.permute(0, 2, 1, 3).contiguous(), m[..., 0].contiguous(), l[..., 0].contiguous()


# ----------------------------------------------------------------- the kernels


def _check(what: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    tensors = (q,) + others
    if q.dtype not in DTYPE_CODES or any(x.dtype != q.dtype for x in others):
        raise TypeError(
            f"{what} takes float32, bfloat16 or float16 q, k, v of one dtype, got "
            f"{[x.dtype for x in tensors]}")
    if q.device.type != "cuda" or any(x.device != q.device for x in others):
        raise ValueError(f"{what} needs q, k, v on one CUDA device")
    if min(q.shape) == 0 or any(min(x.shape) == 0 for x in others):
        raise ValueError(f"{what} needs non-empty q, k, v")
    if any(x.stride(3) != 1 for x in tensors):
        raise ValueError(f"{what} needs the head dim of q, k, v contiguous")


def _strides(q, k, v):
    return (ctypes.c_longlong * 9)(*(x.stride(i) for x in (q, k, v) for i in range(3)))


def _scale(head_dim: int, scale: Optional[float]) -> float:
    return head_dim**-0.5 if scale is None else scale


def forward_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
    need_lse: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the wide forward: o contiguous [B, S, H, D] in q.dtype and, if
    asked, lse [B, H, S] float32."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"the wide forward takes q, k, v of one [B, S, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _check("the wide forward", q, k, v)
    batch, seq, heads, head_dim = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device) if need_lse \
        else None
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_wide_forward(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), _strides(q, k, v),
            batch, seq, heads, head_dim, _scale(head_dim, scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    LIBRARY.check(code, "wide flash attention forward kernel")
    FORWARD.launches += 1
    return o, lse


def backward_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the wide backward: dq, dk, dv (contiguous [B, S, H, D], q.dtype).
    Past S = WIDE_KEYS each key tile writes an fp32 dQ partial, summed here in
    tile order."""
    _check("the wide backward", q, k, v)
    batch, seq, heads, head_dim = q.shape
    for name, x in (("k", k), ("v", v), ("o", o), ("dout", dout)):
        if x.shape != q.shape:
            raise ValueError(f"the wide backward needs {name} shaped like q")
    for name, x in (("o", o), ("dout", dout)):
        if x.dtype != q.dtype or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"the wide backward needs a contiguous {name} like q")
    if lse.shape != (batch, heads, seq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("the wide backward needs a contiguous float32 lse [B, H, S]")
    tiles = -(-seq // WIDE_KEYS)
    dq = dq_partial = None
    if tiles == 1:
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    else:
        dq_partial = torch.zeros((tiles, *q.shape), dtype=torch.float32, device=q.device)
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_wide_backward(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), None if dq is None else dq.data_ptr(),
            None if dq_partial is None else dq_partial.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v), batch, seq, heads, head_dim, _scale(head_dim, scale),
            int(causal), torch.cuda.current_stream(q.device).cuda_stream,
        )
    LIBRARY.check(code, "wide flash attention backward kernel")
    BACKWARD.launches += 1
    if dq_partial is not None:
        dq = dq_partial[0]
        for part in dq_partial[1:]:
            dq = dq + part
        dq = dq.to(q.dtype)
    return dq, dk, dv


def chunk_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_positions: torch.Tensor,
    k_positions: torch.Tensor, causal: bool = False, scale: Optional[float] = None,
) -> ChunkResult:
    """Launch the wide chunk kernel (B3 past 256): (pv, m, l) as
    `plain_wide_chunk` returns them."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or (
        (k.shape[0], k.shape[2], k.shape[3]) != (q.shape[0], q.shape[2], q.shape[3])
    ):
        raise ValueError(f"the wide chunk kernel takes q [B, Sq, H, D] and k, v [B, Sk, H, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _check("the wide chunk kernel", q, k, v)
    for name, pos, length in (("q", q_positions, q.shape[1]), ("k", k_positions, k.shape[1])):
        if (pos.dtype != torch.int32 or pos.shape != (length,) or not pos.is_contiguous()
                or pos.device != q.device):
            raise ValueError(f"the wide chunk kernel needs contiguous int32 {name}_positions "
                             f"[{length}] on q's device")
    batch, q_len, heads, head_dim = q.shape
    pv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m, l = (torch.empty((batch, heads, q_len), dtype=torch.float32, device=q.device)
            for _ in range(2))
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_wide_chunk(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_positions.data_ptr(), k_positions.data_ptr(), pv.data_ptr(), m.data_ptr(),
            l.data_ptr(), _strides(q, k, v), batch, q_len, k.shape[1], heads, head_dim,
            _scale(head_dim, scale), int(causal), torch.cuda.current_stream(q.device).cuda_stream,
        )
    LIBRARY.check(code, "wide flash attention chunk kernel")
    CHUNK.launches += 1
    return pv, m, l


# ----------------------------------------------------------------- dispatch and autograd


def _by_device(q: torch.Tensor, kernel, plain, *args):
    if q.device.type == "cuda":
        return kernel(*args)
    if q.device.type == "cpu":
        return plain(*args)
    raise ValueError(f"no wide flash attention kernel for device {q.device}")


class WideFlashAttention(torch.autograd.Function):
    """The wide route with its backward: the forward saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _by_device(q, forward_kernel, plain_wide_forward, q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _by_device(q, backward_kernel, plain_wide_backward, q, k, v, o, lse,
                                dout.contiguous(), ctx.causal)
        return dq, dk, dv, None


def wide_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """[B, S, H, D] -> [B, S, H, D] at any head dim: the wide kernels on CUDA
    tensors (they launch or raise), their plain versions on CPU tensors."""
    # lse is written only where autograd will need it.
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return WideFlashAttention.apply(q, k, v, causal)
    return _by_device(q, forward_kernel, plain_wide_forward, q, k, v, causal)[0]


def wide_flash_attention_chunk(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_positions: torch.Tensor,
    k_positions: torch.Tensor, causal: bool = False,
) -> ChunkResult:
    """B3 at any head dim: the wide chunk kernel on CUDA tensors, its plain
    version on CPU tensors."""
    return _by_device(q, chunk_kernel, plain_wide_chunk, q, k, v, q_positions, k_positions,
                      causal)
