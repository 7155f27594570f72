"""Tensor-parallel building blocks, Megatron's column/row split
(counterpart of stoix_tpu/parallel/tp.py).

For WIDE torsos over a mesh "model" axis, the two-matmul pattern:

  - the FIRST linear layer is COLUMN-parallel: each shard holds W1[:, shard]
    and produces its slice of the hidden activation (no communication), and
  - the SECOND is ROW-parallel: each shard holds W2[shard, :] and
    contributes a partial product, summed by ONE all-reduce over "model".

One collective per block instead of per layer; the hidden dimension (where
the parameters and FLOPs are) never materialises unsharded. The functions
take a rank's own parameter slices and the "model" axis's process group
(`mesh.get_group("model")`), where the JAX package runs inside `shard_map`
with the axis in scope.

The autograd pair: the JAX package's `psum` over "model" is differentiated
with the replicated-cotangent rule (its transpose broadcasts), which is
Megatron's pair of conjugate functions:

  - before the column layer, identity forward and an all-reduce of the
    input's gradient backward (each shard's hidden slice contributes to the
    input's gradient), `_CopyToModelParallel`;
  - after the row layer, an all-reduce forward and an identity backward
    (every shard computes the same loss from the same sum),
    `_ReduceFromModelParallel`.

`torch.distributed.nn.functional.all_reduce` is not that pair: its backward
all-reduces the gradient too (torch 2.x, `_AllReduce.backward`), which on a
loss every shard computes alike gives the model axis's size times the
gradient. Composable with the data axis: inputs batch-sharded over "data"
and weights over "model" give the standard 2-D DP x TP layout.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


class ColumnRowParams(NamedTuple):
    """Parameter slices for one column->row parallel block, global with a
    leading shard axis [m, ...] on the split leaves, or one shard's.

    w1: [d_in, d_hidden/m]   (column shard)
    b1: [d_hidden/m]
    w2: [d_hidden/m, d_out]  (row shard)
    b2: [d_out]              (replicated; added once, after the all-reduce)
    """

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def init_column_row_params(
    generator: torch.Generator,
    d_in: int,
    d_hidden: int,
    d_out: int,
    num_shards: int,
    dtype: torch.dtype = torch.float32,
) -> ColumnRowParams:
    """Global parameters with a LEADING shard axis on the split dimensions,
    drawn from `generator` (w1's normals first, then w2's): w1
    [m, d_in, d_hidden/m], w2 [m, d_hidden/m, d_out]. A rank takes its
    slice with `shard_params`."""
    if d_hidden % num_shards:
        raise ValueError(f"d_hidden {d_hidden} not divisible by {num_shards} shards")
    local = d_hidden // num_shards
    device = generator.device
    scale1 = 1.0 / torch.sqrt(torch.tensor(float(d_in), dtype=torch.float32))
    scale2 = 1.0 / torch.sqrt(torch.tensor(float(d_hidden), dtype=torch.float32))
    w1 = torch.randn((num_shards, d_in, local), generator=generator, dtype=dtype, device=device)
    w2 = torch.randn((num_shards, local, d_out), generator=generator, dtype=dtype, device=device)
    return ColumnRowParams(
        w1=w1 * scale1.to(device, dtype),
        b1=torch.zeros((num_shards, local), dtype=dtype, device=device),
        w2=w2 * scale2.to(device, dtype),
        b2=torch.zeros((d_out,), dtype=dtype, device=device),
    )


def shard_params(params: ColumnRowParams, index: int) -> ColumnRowParams:
    """Shard `index`'s slices of global params (its singleton leading axis
    kept, as `shard_map` leaves it; `column_row_block` strips it)."""
    cut = slice(index, index + 1)
    return ColumnRowParams(params.w1[cut], params.b1[cut], params.w2[cut], params.b2)


def _all_reduce(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of `x` over `group`, on a copy: NCCL on the card; any other
    backend (gloo) on a host copy."""
    on_host = dist.get_backend(group) != "nccl"
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if on_host:
        out = out.cpu()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device)


class _CopyToModelParallel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModelParallel(torch.autograd.Function):
    """All-reduce over the model axis forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def column_row_block(
    params: ColumnRowParams,
    x: torch.Tensor,
    group: dist.ProcessGroup,
    activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Apply the column->row parallel block to x [..., d_in] with THIS
    shard's parameter slices (a singleton leading shard axis is stripped),
    `group` the "model" axis's process group. Exactly one all-reduce over
    it forward, and one more backward for the input's gradient."""
    activation = activation or torch.relu
    w1, b1, w2 = params.w1, params.b1, params.w2
    if w1.ndim == 3:  # the singleton per-shard axis
        w1, b1, w2 = w1[0], b1[0], w2[0]
    x = _CopyToModelParallel.apply(x, group)
    hidden = activation(x @ w1 + b1)  # [..., d_hidden/m], local
    partial = hidden @ w2  # [..., d_out], a partial sum
    return _ReduceFromModelParallel.apply(partial, group) + params.b2


def reference_block(params: ColumnRowParams, x: torch.Tensor,
                    activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                    ) -> torch.Tensor:
    """The unsharded oracle over the stacked global params: the shard slices
    concatenated back into the full matrices."""
    activation = activation or torch.relu
    w1 = torch.cat(list(params.w1), dim=-1)  # [d_in, d_hidden]
    b1 = torch.cat(list(params.b1), dim=-1)  # [d_hidden]
    w2 = torch.cat(list(params.w2), dim=0)  # [d_hidden, d_out]
    hidden = activation(x @ w1 + b1)
    return hidden @ w2 + params.b2


def tp_specs() -> Tuple[ColumnRowParams, str]:
    """Which leaves are sharded: (each param leaf's mesh axis along its
    leading dimension, None for replicated; the inputs' batch axis). The
    port's counterpart of the JAX package's PartitionSpecs: a rank takes
    `shard_params(params, model_rank)` and its "data" share of the batch."""
    return ColumnRowParams(w1="model", b1="model", w2="model", b2=None), "data"
