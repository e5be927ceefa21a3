"""Transformer building blocks (rovr_tpu/models/attention.py): `_attend`,
`MultiHeadAttention`, `SelfAttentionBlock`, `CrossAttentionBlock`,
`FeedForwardBlock`, `EncoderBlock` (dense FFN, or the mixture-of-experts
FFN of models/moe.py with moe_experts > 0), `DecoderBlock` and the learned
positional encodings `ImagePositionalEncoding` and
`ContextPositionalEncoding`. The attention context policy builds the
encoder blocks; nothing on a driver path builds the decoder, the cross
attention or the encodings (the original kept them from an older policy),
and they are here for parity.

Submodules keep the flax names (`SelfAttentionBlock_0`,
`MultiHeadAttention_0`, `LayerNorm_0`, `Dense_0`, ...) so JAX weights carry
over by rule; q/k/v/out are `DenseGeneral`s with flax's 3-D kernel layouts.

Traps copied from the JAX package: `SelfAttentionBlock` returns
LN(x) + MHA(LN(x)) and `EncoderBlock` adds x again (not the textbook pre-LN
block); `CrossAttentionBlock` returns LN_0(x) + MHA(LN_0(x), LN_1(enc)),
so cross attention reaches the flash op with Lq != Lk; flax's LayerNorm
uses eps 1e-6 and, with f32 params, returns f32; `nn.gelu` is the tanh
approximation; the positional encodings are Dense(1 -> dim) over `arange`
(flax kernel (1, dim), here a Linear weight (dim, 1)).

Not ported: ring attention (`attn_impl="ring"`) and expert parallelism.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rovr_torch.models.layers import DenseGeneral, LayerNorm, Linear
from rovr_torch.models.moe import MoEFeedForward
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


class CrossAttentionBlock(nn.Module):
    """y = LN_0(x); y + MHA(y, LN_1(encoder_output))."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto"):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden_dim)
        self.LayerNorm_1 = LayerNorm(hidden_dim)
        self.MultiHeadAttention_0 = MultiHeadAttention(hidden_dim, num_heads, dtype,
                                                       attn_impl)

    def forward(self, x: torch.Tensor, encoder_output: torch.Tensor) -> torch.Tensor:
        y = self.LayerNorm_0(x)
        return y + self.MultiHeadAttention_0(y, self.LayerNorm_1(encoder_output))


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
    """x + SA(x); then x + FF(x), where FF is the dense FeedForwardBlock, or
    with moe_experts > 0 the switch-routed MoEFeedForward (`moe_ff`)."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto",
                 moe_experts: int = 0, moe_capacity: float = 1.25):
        super().__init__()
        self.SelfAttentionBlock_0 = SelfAttentionBlock(hidden_dim, num_heads, dtype,
                                                       attn_impl)
        if moe_experts > 0:
            self.moe_ff = MoEFeedForward(hidden_dim, moe_experts, moe_capacity, dtype)
        else:
            self.FeedForwardBlock_0 = FeedForwardBlock(hidden_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.SelfAttentionBlock_0(x)
        ff = self.moe_ff if hasattr(self, "moe_ff") else self.FeedForwardBlock_0
        return x + ff(x)


class DecoderBlock(nn.Module):
    """x + SA(x); x + CA(x, encoder_output); x + FF(x)."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto"):
        super().__init__()
        self.SelfAttentionBlock_0 = SelfAttentionBlock(hidden_dim, num_heads, dtype,
                                                       attn_impl)
        self.CrossAttentionBlock_0 = CrossAttentionBlock(hidden_dim, num_heads, dtype,
                                                         attn_impl)
        self.FeedForwardBlock_0 = FeedForwardBlock(hidden_dim, dtype)

    def forward(self, x: torch.Tensor, encoder_output: torch.Tensor) -> torch.Tensor:
        x = x + self.SelfAttentionBlock_0(x)
        x = x + self.CrossAttentionBlock_0(x, encoder_output)
        return x + self.FeedForwardBlock_0(x)


def _positions(dense: Linear, n: int) -> torch.Tensor:
    """Dense(1 -> dim) of arange(n): (n, dim) f32."""
    idx = torch.arange(n, dtype=torch.float32, device=dense.weight.device)
    return dense(idx[:, None])


class ImagePositionalEncoding(nn.Module):
    """x + a learned linear encoding of the patch index:
    (B, num_image_patches^2, patch_size^2 * num_channels)."""

    def __init__(self, num_image_patches: int, patch_size: int, num_channels: int):
        super().__init__()
        self.n = num_image_patches ** 2
        self.positional_encoder = Linear(1, patch_size ** 2 * num_channels,
                                         compute_dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + _positions(self.positional_encoder, self.n)[None]


class ContextPositionalEncoding(nn.Module):
    """Learned per-patch plus per-context-frame encodings:
    x (B, num_context, P, dim) -> (B, num_context * P, dim)."""

    def __init__(self, num_context_patches: int, patch_size: int, num_channels: int,
                 num_context: int):
        super().__init__()
        self.p = num_context_patches ** 2
        self.num_context = num_context
        self.dim = patch_size ** 2 * num_channels
        self.patch_positional_encoder = Linear(1, self.dim, compute_dtype=torch.float32)
        self.context_positional_encoder = Linear(1, self.dim, compute_dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        patch = _positions(self.patch_positional_encoder, self.p)
        ctx = _positions(self.context_positional_encoder, self.num_context)
        y = x + (patch[None, None] + ctx[None, :, None])
        return y.reshape(x.shape[0], self.num_context * self.p, self.dim)
