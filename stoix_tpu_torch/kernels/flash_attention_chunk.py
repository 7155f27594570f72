"""Flash attention over one K/V chunk: the Hopper CUDA kernel, its plain
PyTorch version, and the error measure that holds one against the other.
ops/pallas_attention.py::flash_attention_chunk picks one by the tensors'
device.

    m  = max_k s_qk,   l = sum_k exp(s_qk - m),   pv = sum_k exp(s_qk - m) . v
    s_qk = q * scale . k,   scale = D^-1/2,   over the keys with k_pos <= q_pos
    (causal) or all keys of the chunk

Replaces: stoix_tpu/ops/pallas_attention.py::flash_attention_chunk (body
`_flash_chunk_kernel`), the Pallas TPU kernel ring attention calls once per
ring step: q [B, Sq, H, D] is the rank's query shard, k and v [B, Sk, H, D]
the K/V block the step holds, and the positions are GLOBAL sequence positions
(int32 [Sq], [Sk]), so a rotated block is masked right. It returns the
unnormalised accumulator pv [B, Sq, H, D] and the row statistics m and l
[B, H, Sq], all float32, for the ring to fold. A row that sees no key gets
m = 0 (a finite proxy), l = 0 and pv = 0, as the TPU kernel writes it.

Bound on an H100 at the ring's shapes: operations. A fully visible
[64, 128, 4, 32] float32 chunk does 4.D.Sq.Sk flops per (batch, head),
0.54 GFLOP, about 8 µs at 67 TFLOP/s of fp32, against about 16.8 MB of q,
k, v and pv (5 µs at 3.35 TB/s); a diagonal chunk does half the flops; a chunk
wholly in the queries' future needs no K/V at all.

Design (csrc/flash_attention_chunk.cu on csrc/flash_forward.cuh, the forward
core B2's forward shares): 64 query rows a block (several (batch, head) pairs
when the chunk is short), q, K and V copied as 16-byte coalesced pieces into
padded fp32 tiles, scores and the online softmax in register tiles with the
row max and sum taken by shuffles, the accumulator in register tiles, folded
over key tiles of up to KEY_TILE keys; each key masked by its own position,
staged with its tile. A block whose chunk lies wholly in its queries' future
writes the proxy stats and zeros as coalesced stores without reading q, K or
V, and a key tile wholly beyond the block's last query is skipped before its
K/V are copied. q, k, v are taken by strides; their rows must be 16-byte
aligned (a ValueError otherwise). They may be float32, bfloat16 or float16,
at the head dims B2 is built for (HEAD_DIMS, 8 to 256); the dispatch
(ops/pallas_attention.py::flash_attention_chunk) zero-pads any other head dim
up to 256 and passes the true D^-1/2 as `scale`, and sends any wider one to the
wide chunk kernel (kernels/flash_attention_wide.py). The TPU kernel's block sizes (which must
divide the chunk lengths) do not shape this kernel's tiling.

Counter: `KERNEL` counts this kernel's launches and rises nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from stoix_tpu_torch.kernels.attention_common import (
    DTYPE_CODES, KernelCounter, check_rows_aligned, fold_key_tiles, heads_first,
)
from stoix_tpu_torch.kernels.build import CudaLibrary
from stoix_tpu_torch.kernels.flash_attention import HEAD_DIMS

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

LIBRARY = CudaLibrary(
    "flash_attention_chunk.cu",
    {
        # dtype, q, k, v, q_pos, k_pos, pv, m, l, strides, batch, q_len, k_len,
        # heads, head_dim, scale, causal, stream
        "flash_attention_chunk": [_I] + [_P] * 9 + [_I] * 5 + [_F, _I, _P],
    },
    error_entry="flash_attention_chunk_error_string",
)
KERNEL = KernelCounter("flash_attention_chunk")

ChunkResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def plain_flash_attention_chunk(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_positions: torch.Tensor,
    k_positions: torch.Tensor, causal: bool = False, scale: Optional[float] = None,
) -> ChunkResult:
    """The kernel's arithmetic in plain PyTorch: the chunk's keys folded
    KEY_TILE at a time into an fp32 online softmax, each masked by its global
    position (`scale` defaults to D^-1/2). Returns (pv [B, Sq, H, D],
    m [B, H, Sq], l [B, H, Sq]), float32, with m = 0 on a row that saw no key."""
    qs = heads_first(q) * (q.shape[3] ** -0.5 if scale is None else scale)
    positions = (q_positions, k_positions) if causal else (None, None)
    m, l, acc = fold_key_tiles(qs, heads_first(k), heads_first(v), *positions)
    m = torch.where(torch.isfinite(m), m, 0.0)
    return acc.permute(0, 2, 1, 3).contiguous(), m[..., 0].contiguous(), l[..., 0].contiguous()


def _check(q, k, v, q_positions, k_positions) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or (
        (k.shape[0], k.shape[2], k.shape[3]) != (q.shape[0], q.shape[2], q.shape[3])
    ):
        raise ValueError(
            f"the chunk kernel takes q [B, Sq, H, D] and k, v [B, Sk, H, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"the chunk kernel takes float32, bfloat16 or float16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    tensors = (q, k, v, q_positions, k_positions)
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError("the chunk kernel needs q, k, v and the positions on one CUDA device")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the chunk kernel takes head dims {HEAD_DIMS}, got {q.shape[3]}")
    if min(q.shape) == 0 or k.shape[1] == 0:
        raise ValueError("the chunk kernel needs non-empty q, k, v")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("the chunk kernel needs the head dim of q, k, v contiguous")
    for name, pos, length in (("q", q_positions, q.shape[1]), ("k", k_positions, k.shape[1])):
        if pos.dtype != torch.int32 or pos.shape != (length,) or not pos.is_contiguous():
            raise ValueError(f"the chunk kernel needs contiguous int32 {name}_positions [{length}]")


def chunk_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_positions: torch.Tensor,
    k_positions: torch.Tensor, causal: bool = False, scale: Optional[float] = None,
) -> ChunkResult:
    """Launch the kernel on CUDA tensors (or raise); returns (pv, m, l) as
    `plain_flash_attention_chunk` does."""
    _check(q, k, v, q_positions, k_positions)
    check_rows_aligned("the chunk kernel", q, k, v)
    batch, q_len, heads, head_dim = q.shape
    pv = torch.empty((batch, q_len, heads, head_dim), dtype=torch.float32, device=q.device)
    m, l = (torch.empty((batch, heads, q_len), dtype=torch.float32, device=q.device)
            for _ in range(2))
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        strides = (ctypes.c_longlong * 9)(*(x.stride(i) for x in (q, k, v) for i in range(3)))
        code = lib.flash_attention_chunk(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_positions.data_ptr(), k_positions.data_ptr(), pv.data_ptr(), m.data_ptr(),
            l.data_ptr(), strides, batch, q_len, k.shape[1], heads, head_dim,
            head_dim**-0.5 if scale is None else scale, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    LIBRARY.check(code, "flash attention chunk kernel")
    KERNEL.launches += 1
    return pv, m, l


def chunk_errors(got: ChunkResult, want: ChunkResult) -> Tuple[float, float, float]:
    """Errors of a chunk result (pv, m, l) against another: m absolute, l and
    pv relative to the row's l (at least 1), since pv is the unnormalised sum
    and its scale is l's."""
    pv, m, l = got
    want_pv, want_m, want_l = want
    scale = want_l.clamp(min=1.0)
    return ((m - want_m).abs().max().item(), ((l - want_l).abs() / scale).max().item(),
            ((pv - want_pv).abs() / scale.permute(0, 2, 1)[..., None]).max().item())
