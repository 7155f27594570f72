"""Attention networks (counterpart of stoix_tpu/networks/attention.py):
multi-head self-attention, a pre-LN transformer block and a causal transformer
torso over the time axis.

`attention_fn(q, k, v, causal=...)` takes and returns [B, T, H, D]; None means
`best_attention`, which runs kernel B2 (kernels/flash_attention.py) on a CUDA
tensor and plain full attention on a CPU tensor. The projections stay
`F.linear`, as the JAX package leaves them to XLA.

Layer names follow the flax parameter tree (utils/params.py carries one
across): `qkv` and `out` in the attention, `norm.0`/`norm.1` and
`dense.0`/`dense.1` in a block, `dense.0`, `positional_embedding`,
`blocks.i` and `norm.0` in the torso. Inits are flax's: the `qkv` kernel
[F, 3, H, D] is orthogonal(1.0) as an [F.3.H, D] matrix (flax's column axis
-1), `out` orthogonal(1.0), the input and FFN Dense orthogonal(sqrt 2), the
positional embedding normal(0.02), biases zero; LayerNorm eps is flax's 1e-6.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from stoix_tpu_torch.networks.torso import init_linear
from stoix_tpu_torch.ops.pallas_attention import best_attention

AttentionFn = Callable[..., torch.Tensor]  # (q, k, v, causal=...) -> out
_SQRT2 = 2.0**0.5


def _layer_norm(width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=1e-6)


class MultiHeadSelfAttention(nn.Module):
    def __init__(
        self,
        input_dim: int,
        num_heads: int = 4,
        head_dim: int = 32,
        causal: bool = True,
        attention_fn: Optional[AttentionFn] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_heads, self.head_dim, self.causal = int(num_heads), int(head_dim), bool(causal)
        self.attention_fn = attention_fn
        width = self.num_heads * self.head_dim
        self.qkv = nn.Linear(input_dim, 3 * width)
        with torch.no_grad():
            kernel = torch.empty(input_dim * 3 * self.num_heads, self.head_dim)
            nn.init.orthogonal_(kernel, gain=1.0, generator=generator)
            self.qkv.weight.copy_(kernel.reshape(input_dim, 3 * width).T)
            self.qkv.bias.zero_()
        self.out = init_linear(nn.Linear(width, width), 1.0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [B, T, F] -> [B, T, H*D]
        b, t, _ = x.shape
        proj = self.qkv(x).view(b, t, 3, self.num_heads, self.head_dim)
        q, k, v = proj[:, :, 0], proj[:, :, 1], proj[:, :, 2]  # strided [B, T, H, D] views
        attend = self.attention_fn or best_attention
        out = attend(q, k, v, causal=self.causal)
        return self.out(out.reshape(b, t, self.num_heads * self.head_dim))


class TransformerBlock(nn.Module):
    """Pre-LN: x + attention(LN(x)), then x + FFN(LN(x)) with a silu FFN."""

    def __init__(
        self,
        num_heads: int = 4,
        head_dim: int = 32,
        ffn_dim: int = 256,
        causal: bool = True,
        attention_fn: Optional[AttentionFn] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        width = int(num_heads) * int(head_dim)
        self.attention = MultiHeadSelfAttention(
            width, num_heads, head_dim, causal, attention_fn, generator
        )
        self.norm = nn.ModuleList([_layer_norm(width), _layer_norm(width)])
        self.dense = nn.ModuleList([
            init_linear(nn.Linear(width, int(ffn_dim)), _SQRT2, generator),
            init_linear(nn.Linear(int(ffn_dim), width), _SQRT2, generator),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.norm[0](x))
        h = F.silu(self.dense[0](self.norm[1](x)))
        return x + self.dense[1](h)


class TransformerTorso(nn.Module):
    """Causal transformer over the time axis: [B, T, F] -> [B, T, width]."""

    def __init__(
        self,
        input_dim: int,
        num_layers: int = 2,
        num_heads: int = 4,
        head_dim: int = 32,
        ffn_dim: int = 256,
        max_timesteps: int = 512,
        causal: bool = True,
        attention_fn: Optional[AttentionFn] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        width = int(num_heads) * int(head_dim)
        self.output_dim = width
        self.dense = nn.ModuleList([init_linear(nn.Linear(input_dim, width), _SQRT2, generator)])
        self.positional_embedding = nn.Parameter(torch.empty(int(max_timesteps), width))
        with torch.no_grad():
            self.positional_embedding.normal_(0.0, 0.02, generator=generator)
        self.blocks = nn.ModuleList(
            TransformerBlock(num_heads, head_dim, ffn_dim, causal, attention_fn, generator)
            for _ in range(int(num_layers))
        )
        self.norm = nn.ModuleList([_layer_norm(width)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        x = self.dense[0](x) + self.positional_embedding[:t][None]
        for block in self.blocks:
            x = block(x)
        return self.norm[0](x)
