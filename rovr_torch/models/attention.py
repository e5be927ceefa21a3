"""Transformer building blocks of the attention context policy
(rovr_tpu/models/attention.py): `_attend`, `MultiHeadAttention`,
`SelfAttentionBlock`, `FeedForwardBlock` and `EncoderBlock` (dense FFN).

Submodules keep the flax names (`SelfAttentionBlock_0`,
`MultiHeadAttention_0`, `LayerNorm_0`, `Dense_0`, ...) so JAX weights carry
over by rule; q/k/v/out are `DenseGeneral`s with flax's 3-D kernel layouts.

Traps copied from the JAX package: `SelfAttentionBlock` returns
LN(x) + MHA(LN(x)) and `EncoderBlock` adds x again (not the textbook pre-LN
block); flax's LayerNorm uses eps 1e-6 and, with f32 params, returns f32;
`nn.gelu` is the tanh approximation.

Not ported: CrossAttentionBlock, DecoderBlock and the positional encodings
(nothing on the attention policy's path builds them), ring attention and the
mixture-of-experts FFN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rovr_torch.models.layers import DenseGeneral, LayerNorm, Linear
from rovr_torch.ops.attention import flash_attention

ATTN_IMPLS = ("auto", "pallas", "jnp", "ring")


def attend_plain(q, k, v):
    """The JAX package's jnp path: logits in q's dtype, softmax in f32,
    weights cast back to q's dtype."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (q.shape[-1] ** -0.5)
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def _attend(q, k, v, impl: str = "auto"):
    """q, k, v (B,H,L,D). "auto"/"pallas": the flash op (K2-K4 on CUDA
    tensors, their plain twins on CPU tensors; unlike the TPU gate there is
    no size envelope). "jnp": the plain path. "ring": not ported."""
    if impl == "ring":
        raise NotImplementedError("attn_impl='ring' (ring attention) is not in the port")
    if impl in ("auto", "pallas"):
        return flash_attention(q, k, v)
    return attend_plain(q, k, v)


class MultiHeadAttention(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        if attn_impl == "ring":
            raise NotImplementedError("attn_impl='ring' (ring attention) is not in the port")
        h, d = num_heads, hidden_dim // num_heads
        self.q = DenseGeneral((hidden_dim,), (h, d), dtype)
        self.k = DenseGeneral((hidden_dim,), (h, d), dtype)
        self.v = DenseGeneral((hidden_dim,), (h, d), dtype)
        self.out = DenseGeneral((h, d), (hidden_dim,), dtype)
        self.attn_impl = attn_impl

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        q = self.q(q_in).transpose(1, 2)
        k = self.k(kv_in).transpose(1, 2)
        v = self.v(kv_in).transpose(1, 2)
        o = _attend(q, k, v, self.attn_impl).transpose(1, 2)
        return self.out(o)


class SelfAttentionBlock(nn.Module):
    """y = LN(x); y + MHA(y, y)."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto"):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden_dim)
        self.MultiHeadAttention_0 = MultiHeadAttention(hidden_dim, num_heads, dtype,
                                                       attn_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.LayerNorm_0(x)
        return y + self.MultiHeadAttention_0(y, y)


class FeedForwardBlock(nn.Module):
    """LN -> Dense(hidden/4) -> GELU (tanh) -> Dense(hidden); dropout 0."""

    def __init__(self, hidden_dim: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden_dim)
        self.Dense_0 = Linear(hidden_dim, hidden_dim // 4, compute_dtype=dtype)
        self.Dense_1 = Linear(hidden_dim // 4, hidden_dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Dense_0(self.LayerNorm_0(x))
        return self.Dense_1(F.gelu(y, approximate="tanh"))


class EncoderBlock(nn.Module):
    """x + SA(x); then x + FF(x). The mixture-of-experts FFN
    (moe_experts > 0) is not ported."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto",
                 moe_experts: int = 0):
        super().__init__()
        if moe_experts > 0:
            raise NotImplementedError("attn_moe_experts > 0 (MoE FFN) is not in the port")
        self.SelfAttentionBlock_0 = SelfAttentionBlock(hidden_dim, num_heads, dtype,
                                                       attn_impl)
        self.FeedForwardBlock_0 = FeedForwardBlock(hidden_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.SelfAttentionBlock_0(x)
        return x + self.FeedForwardBlock_0(x)
