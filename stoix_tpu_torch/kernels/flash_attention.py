"""Flash attention: the Hopper CUDA kernels (a forward and a fused backward),
their plain PyTorch versions, the autograd function that joins them,
and the wrappers that pick a version by the tensors' device.

    o = softmax(q * scale . k^T) . v     over [B, S, H, D],   scale = D^-1/2

Replaces: stoix_tpu/ops/pallas_attention.py::flash_attention (body
`_flash_kernel`, fold `_fold_block`), the Pallas TPU kernel behind
`best_attention` and so behind every attention layer of the transformer torso.
On the Anakin ff_trans_ppo main path it runs at S = 16, H = 4, D = 32 float32,
causal, for B = 1024 (rollout), 4096 (minibatch) and 16384 (bootstrap) windows.

The TPU kernel is forward-only (no custom VJP, so `jax.grad` cannot pass
through it); the port trains through its kernel, so `FlashAttention` adds a
recompute-style backward whose kernel is hand-written too: dQ, dK and dV in
one launch. It is held against `jax.grad` of the JAX package's
`full_attention`, which is what that package differentiates wherever it
trains this model.

Bound on an H100: bytes. The forward reads q, k, v once and writes o once;
at S = 16, D = 32 its work is at most 4.S^2.D flops per (batch, head), about
4 flops per byte, far below the card's float32 balance point of 20. At
B = 4096 it moves 128 MiB, about 40 µs at 3.35 TB/s. The backward reads q, k,
v, o, dO and lse once and writes dQ, dK, dV once: 257 MiB at B = 4096, about
80 µs.

Design. Forward (csrc/flash_forward.cuh, the core B3 shares): a block holds
64 query rows (several (batch, head) pairs when S is short: 4 at S = 16),
copies q, K and V as 16-byte coalesced pieces into padded fp32 tiles in
shared memory, scores each query row in register tiles shared by 4 lanes
whose max and sum are taken by shuffles, folds the online softmax per key
tile of up to KEY_TILE keys as `_fold_block` folds a block, keeps the output
in register tiles and stores it through shared memory as 16-byte pieces.
Backward (csrc/flash_attention.cu): a block holds `backward_tile(D)` rows of
each side (64; 32 at D = 256, whose 64-row tiles would outgrow shared memory),
loads them the same way, forms delta, then P and dS once (2 x 2 register
tiles kept in shared memory), then dV, dK and dQ as 4 x 4 register tiles, and
stores through shared memory as 16-byte pieces.
Past S = `backward_tile(D)` a backward block owns one key tile of that many
keys and walks the query tiles; each key tile then writes an fp32 dQ partial
that `backward_kernel` sums in a fixed order (deterministic, no atomics). Both: ragged S masked, not padded;
causal walks bounded. q, k, v are taken by strides, so the views of the fused
qkv projection need no copy; every row must be 16-byte aligned, which those
views are at every head dim the kernels take, and anything else is refused
with a ValueError (`check_rows_aligned`).

Head dims and dtypes: the kernels are built for HEAD_DIMS (8 to 256) in
float32, bfloat16 and float16, as the TPU kernel takes any head dim and
float dtype. `flash_attention` runs any other head dim up to 256 on the card
zero-padded to the next built one (`kernel_head_dim`, `padded_flash_attention`):
the zero columns add nothing to q.k, the scale stays D^-1/2 of the true D,
and the output's padded columns are cut off. Past 256, where the forward
core's whole-head-dim tiles outgrow shared memory, every head dim takes the
wide route (`takes_wide_route`, kernels/flash_attention_wide.py), whose
kernels stream the head dim in chunks.

Counters: `FORWARD` and `BACKWARD` each count the launches of one kernel, and
rise nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from stoix_tpu_torch.kernels.attention_common import (
    DTYPE_CODES, KEY_TILE, KernelCounter, check_rows_aligned, fold_key_tiles, heads_first,
    plain_exp, seq_first,
)
from stoix_tpu_torch.kernels.build import CudaLibrary
from stoix_tpu_torch.kernels.flash_attention_wide import wide_flash_attention

HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # csrc/flash_forward.cuh::built_head_dim's


def backward_tile(head_dim: int) -> int:
    """Rows of each side a backward block holds at `head_dim`
    (csrc/flash_attention.cu::bwd_rows): 64, or 32 at D = 256."""
    return 32 if head_dim > 128 else 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# strides, batch, seq, heads, head_dim, scale, causal, stream
_SHAPE_ARGS = [_P, _I, _I, _I, _I, _F, _I, _P]

LIBRARY = CudaLibrary(
    "flash_attention.cu",
    {
        "flash_attention_forward": [_I] + [_P] * 5 + _SHAPE_ARGS,
        "flash_attention_backward": [_I] + [_P] * 10 + _SHAPE_ARGS,
    },
    error_entry="flash_attention_error_string",
)


FORWARD = KernelCounter("flash_attention_forward")
BACKWARD = KernelCounter("flash_attention_backward")
COUNTERS = (FORWARD, BACKWARD)


# ----------------------------------------------------------------- plain versions


def plain_flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
    need_lse: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernel's arithmetic in plain PyTorch: the online softmax
    folded over key tiles of KEY_TILE as `_fold_block` folds its blocks.
    `scale` defaults to D^-1/2. Returns o [B, S, H, D] in q.dtype and, if
    asked, lse [B, H, S] float32."""
    seq = q.shape[1]
    scale = q.shape[3] ** -0.5 if scale is None else scale
    qs, kf, vf = heads_first(q) * scale, heads_first(k), heads_first(v)
    positions = torch.arange(seq, device=q.device) if causal else None
    m, l, acc = fold_key_tiles(qs, kf, vf, positions, positions)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = seq_first(acc / l_safe, q.dtype)
    if not need_lse:
        return o, None
    lse = torch.where(l == 0.0, float("inf"), m + torch.log(l))
    return o, lse[..., 0].contiguous()


def plain_flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic, in its order: delta = rowsum(dO.O);
    P = exp(q.scale.K^T - lse) and dS = P.(dO V^T - delta), once; then
    dQ = scale.dS K, dK = dS^T (q.scale), dV = P^T dO (scale defaults to
    D^-1/2). Returns dq, dk, dv (contiguous [B, S, H, D], q.dtype)."""
    seq = q.shape[1]
    scale = q.shape[3] ** -0.5 if scale is None else scale
    qs, kf, vf, dof = heads_first(q) * scale, heads_first(k), heads_first(v), heads_first(dout)
    delta = (dof * heads_first(o)).sum(-1)
    p = plain_exp(qs @ kf.transpose(-1, -2) - lse[..., None])
    if causal:
        p = torch.where(torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril(), p, 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    dq = (ds @ kf) * scale
    dk = ds.transpose(-1, -2) @ qs
    dv = p.transpose(-1, -2) @ dof
    return seq_first(dq, q.dtype), seq_first(dk, q.dtype), seq_first(dv, q.dtype)


# ----------------------------------------------------------------- the kernels


def kernel_head_dim(head_dim: int) -> int:
    """The head dim the kernels (B2 and B3) run `head_dim` at: itself if they
    are built for it, else the next one they are built for, to which the
    dispatch zero-pads q, k and v. Past HEAD_DIMS[-1] raises."""
    for width in HEAD_DIMS:
        if width >= head_dim:
            return width
    raise ValueError(
        f"flash attention kernels take head dims up to {HEAD_DIMS[-1]}, got {head_dim} "
        "(wider head dims take the wide route, `takes_wide_route`)")


def pad_head_dim(width: int, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors with their last dim zero-padded to `width` (differentiable)."""
    return tuple(F.pad(x, (0, width - x.shape[-1])) for x in tensors)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash attention takes q, k, v of one [B, S, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash attention kernels take float32, bfloat16 or float16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash attention kernels need q, k, v on one CUDA device")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head dims {HEAD_DIMS}, got {q.shape[3]}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("flash attention kernels need the head dim of q, k, v contiguous")


def _launch_args(q, k, v, causal, scale):
    batch, seq, heads, head_dim = q.shape
    strides = (ctypes.c_longlong * 9)(*(x.stride(i) for x in (q, k, v) for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = head_dim**-0.5 if scale is None else scale
    return strides, [batch, seq, heads, head_dim, scale, int(causal), stream]


def forward_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
    need_lse: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel; o contiguous [B, S, H, D] in q.dtype and, if
    asked, lse [B, H, S] float32. `scale` defaults to D^-1/2."""
    _check(q, k, v)
    check_rows_aligned("flash attention forward", q, k, v)
    batch, seq, heads, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = None
    if need_lse:
        lse = torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        strides, shape = _launch_args(q, k, v, causal, scale)
        code = lib.flash_attention_forward(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), strides, *shape,
        )
    LIBRARY.check(code, "flash attention forward kernel")
    FORWARD.launches += 1
    return o, lse


def _check_backward(q: torch.Tensor, lse: torch.Tensor, **like_q: torch.Tensor) -> None:
    batch, seq, heads, _ = q.shape
    for name, x in like_q.items():
        if (x.shape, x.dtype, x.device) != (q.shape, q.dtype, q.device) or not x.is_contiguous():
            raise ValueError(f"flash attention backward needs a contiguous {name} like q")
    if lse.shape != (batch, heads, seq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash attention backward needs a contiguous float32 lse [B, H, S]")


def backward_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, causal: bool = False, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: dq, dk, dv (contiguous [B, S, H, D],
    q.dtype) in one launch (`scale` defaults to D^-1/2). Past S =
    `backward_tile(D)` each key tile writes an fp32 dQ partial, summed here
    in tile order."""
    _check(q, k, v)
    _check_backward(q, lse, o=o, dout=dout)
    check_rows_aligned("flash attention backward", q, k, v, o, dout)
    tiles = -(-q.shape[1] // backward_tile(q.shape[3]))
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    dq = partial = None
    if tiles == 1:
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    else:
        partial = torch.zeros((tiles, *q.shape), dtype=torch.float32, device=q.device)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        strides, shape = _launch_args(q, k, v, causal, scale)
        code = lib.flash_attention_backward(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), None if dq is None else dq.data_ptr(),
            None if partial is None else partial.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            strides, *shape,
        )
    LIBRARY.check(code, "flash attention backward kernel")
    BACKWARD.launches += 1
    if partial is not None:
        dq = partial.sum(0).to(q.dtype)
    return dq, dk, dv


# ----------------------------------------------------------------- dispatch and autograd


def _forward(q, k, v, causal, need_lse, scale):
    if q.device.type == "cuda":
        return forward_kernel(q, k, v, causal, need_lse, scale)
    if q.device.type == "cpu":
        return plain_flash_attention_forward(q, k, v, causal, need_lse, scale)
    raise ValueError(f"no flash attention kernel for device {q.device}")


def _backward(q, k, v, o, lse, dout, causal, scale):
    if q.device.type == "cuda":
        return backward_kernel(q, k, v, o, lse, dout, causal, scale)
    if q.device.type == "cpu":
        return plain_flash_attention_backward(q, k, v, o, lse, dout, causal, scale)
    raise ValueError(f"no flash attention kernel for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Flash attention with a flash backward: the forward saves q, k, v, o and
    lse; the backward recomputes the probabilities from lse. `scale` None
    means D^-1/2."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale=None):
        o, lse = _forward(q, k, v, causal, True, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, dout.contiguous(), ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def _attend(q, k, v, causal, scale):
    # lse is written only where autograd will need it.
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, False, scale)[0]


def padded_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, width: int
) -> torch.Tensor:
    """Attention at q's head dim D computed at head dim `width` >= D: q, k, v
    zero-padded to it, the scale D^-1/2, and the output's padded columns cut
    off. The kernels on CUDA tensors, their plain versions on CPU tensors."""
    head_dim = q.shape[-1]
    return _attend(*pad_head_dim(width, q, k, v), causal, head_dim**-0.5)[..., :head_dim]


def takes_wide_route(head_dim: int) -> bool:
    """Whether attention at `head_dim` goes to the wide route
    (kernels/flash_attention_wide.py): every head dim past HEAD_DIMS[-1]."""
    return head_dim > HEAD_DIMS[-1]


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """[B, S, H, D] -> [B, S, H, D]: the kernels on CUDA tensors (they launch
    or raise), their plain versions on CPU tensors. On CUDA a head dim up to
    256 the kernels are not built for runs padded to the next one that is
    (`kernel_head_dim`); past 256 every device takes the wide route."""
    head_dim = q.shape[-1]
    if takes_wide_route(head_dim):
        return wide_flash_attention(q, k, v, causal)
    if q.device.type == "cuda" and head_dim not in HEAD_DIMS:
        return padded_flash_attention(q, k, v, causal, kernel_head_dim(head_dim))
    return _attend(q, k, v, causal, None)
