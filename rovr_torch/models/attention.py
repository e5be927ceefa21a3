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

On a mesh (`parallel.mesh`): `attn_impl="ring"` runs ring attention over
`seq_axis` (parallel/ring_attention.py), and needs a mesh and the axis;
`tensor_parallel=True` gives each model rank its heads and FFN columns
(parallel/tp.py), with the collectives written out; with both, the heads
are gathered for the ring and split again after it. An MoE FFN bound to a
mesh shards its experts over the model axis (models/moe.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rovr_torch.models.layers import DenseGeneral, LayerNorm, Linear
from rovr_torch.models.moe import MoEFeedForward
from rovr_torch.ops.attention import flash_attention
from rovr_torch.parallel import collectives, tp
from rovr_torch.parallel.ring_attention import ring_attend

ATTN_IMPLS = ("auto", "pallas", "jnp", "ring")


def attend_plain(q, k, v):
    """The JAX package's jnp path: logits in q's dtype, softmax in f32,
    weights cast back to q's dtype."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (q.shape[-1] ** -0.5)
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def _check_ring(impl: str, mesh, seq_axis) -> None:
    if impl == "ring" and (mesh is None or seq_axis is None):
        raise ValueError("attn_impl='ring' needs mesh and seq_axis")


def _attend(q, k, v, impl: str = "auto", mesh=None, seq_axis=None,
            heads_split: bool = False):
    """q, k, v (B,H,L,D). "auto"/"pallas": the flash op (K2-K4 on CUDA
    tensors, their plain twins on CPU tensors; unlike the TPU gate there is
    no size envelope). "jnp": the plain path. "ring": ring attention over
    `seq_axis` of `mesh` (this rank's batch shard, the whole sequence on
    every rank of the axis); with `heads_split` (tensor parallel, the heads
    split over the same axis) the heads are gathered first and this rank's
    taken back after."""
    if impl == "ring":
        _check_ring(impl, mesh, seq_axis)
        if heads_split:
            q, k, v = (collectives.gather(t, mesh, seq_axis, 1) for t in (q, k, v))
        o = ring_attend(q, k, v, mesh, seq_axis)
        return collectives.split(o, mesh, seq_axis, 1) if heads_split else o
    if impl in ("auto", "pallas"):
        return flash_attention(q, k, v)
    return attend_plain(q, k, v)


class MultiHeadAttention(nn.Module):
    """q/k/v DenseGeneral(hidden -> (H, D)), attention, out ((H, D) ->
    hidden). `tensor_parallel` (needs `mesh`): this model rank's H/mp heads
    of q/k/v/out, the out product row-parallel."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto",
                 mesh=None, seq_axis=None, tensor_parallel: bool = False):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        _check_ring(attn_impl, mesh, seq_axis)
        if tensor_parallel and mesh is None:
            raise ValueError("tensor_parallel needs a mesh")
        h, d = num_heads, hidden_dim // num_heads
        if tensor_parallel:
            h = tp.part(h, mesh, "num_heads")
        self.q = DenseGeneral((hidden_dim,), (h, d), dtype)
        self.k = DenseGeneral((hidden_dim,), (h, d), dtype)
        self.v = DenseGeneral((hidden_dim,), (h, d), dtype)
        self.out = DenseGeneral((h, d), (hidden_dim,), dtype)
        self.attn_impl, self.mesh, self.seq_axis = attn_impl, mesh, seq_axis
        self.tensor_parallel = tensor_parallel
        if tensor_parallel:
            for name in ("q", "k", "v", "out"):
                tp.mark(getattr(self, name), name, mesh)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        if self.tensor_parallel:
            if kv_in is q_in:
                q_in = kv_in = collectives.copy_to_model(q_in, self.mesh)
            else:
                q_in, kv_in = collectives.copy_to_model((q_in, kv_in), self.mesh)
        q = self.q(q_in).transpose(1, 2)
        k = self.k(kv_in).transpose(1, 2)
        v = self.v(kv_in).transpose(1, 2)
        o = _attend(q, k, v, self.attn_impl, self.mesh, self.seq_axis,
                    self.tensor_parallel).transpose(1, 2)
        if not self.tensor_parallel:
            return self.out(o)
        # row-parallel: this rank's heads' partial sums, added over the axis;
        # then the whole bias, once
        y = collectives.reduce_from_model(self.out(o, bias=False), self.mesh)
        return y + self.out.bias.to(y.dtype)


class SelfAttentionBlock(nn.Module):
    """y = LN(x); y + MHA(y, y)."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto",
                 mesh=None, seq_axis=None, tensor_parallel: bool = False):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden_dim)
        self.MultiHeadAttention_0 = MultiHeadAttention(hidden_dim, num_heads, dtype,
                                                       attn_impl, mesh, seq_axis,
                                                       tensor_parallel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.LayerNorm_0(x)
        return y + self.MultiHeadAttention_0(y, y)


class CrossAttentionBlock(nn.Module):
    """y = LN_0(x); y + MHA(y, LN_1(encoder_output))."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto",
                 mesh=None, seq_axis=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden_dim)
        self.LayerNorm_1 = LayerNorm(hidden_dim)
        self.MultiHeadAttention_0 = MultiHeadAttention(hidden_dim, num_heads, dtype,
                                                       attn_impl, mesh, seq_axis)

    def forward(self, x: torch.Tensor, encoder_output: torch.Tensor) -> torch.Tensor:
        y = self.LayerNorm_0(x)
        return y + self.MultiHeadAttention_0(y, self.LayerNorm_1(encoder_output))


class FeedForwardBlock(nn.Module):
    """LN -> Dense(hidden/4) -> GELU (tanh) -> Dense(hidden); dropout 0.
    With `mesh` (tensor parallel): this model rank's hidden/4/mp columns of
    Dense_0 and rows of Dense_1, the latter's product row-parallel."""

    def __init__(self, hidden_dim: int, dtype: torch.dtype = torch.bfloat16, mesh=None):
        super().__init__()
        f = hidden_dim // 4 if mesh is None else tp.part(hidden_dim // 4, mesh, "hidden/4")
        self.LayerNorm_0 = LayerNorm(hidden_dim)
        self.Dense_0 = Linear(hidden_dim, f, compute_dtype=dtype)
        self.Dense_1 = Linear(f, hidden_dim, compute_dtype=dtype)
        self.mesh = mesh
        self.tensor_parallel = mesh is not None
        if mesh is not None:
            tp.mark(self.Dense_0, "Dense_0", mesh)
            tp.mark(self.Dense_1, "Dense_1", mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.LayerNorm_0(x)
        if self.mesh is None:
            return self.Dense_1(F.gelu(self.Dense_0(y), approximate="tanh"))
        y = F.gelu(self.Dense_0(collectives.copy_to_model(y, self.mesh)), approximate="tanh")
        # row-parallel: this rank's columns' partial sums, then the bias
        y = collectives.reduce_from_model(self.Dense_1(y, bias=False), self.mesh)
        return y + self.Dense_1.bias.to(y.dtype)


class EncoderBlock(nn.Module):
    """x + SA(x); then x + FF(x), where FF is the dense FeedForwardBlock, or
    with moe_experts > 0 the switch-routed MoEFeedForward (`moe_ff`)."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto",
                 moe_experts: int = 0, moe_capacity: float = 1.25, mesh=None,
                 seq_axis=None, tensor_parallel: bool = False):
        super().__init__()
        self.SelfAttentionBlock_0 = SelfAttentionBlock(hidden_dim, num_heads, dtype,
                                                       attn_impl, mesh, seq_axis,
                                                       tensor_parallel)
        if moe_experts > 0:
            self.moe_ff = MoEFeedForward(hidden_dim, moe_experts, moe_capacity, dtype,
                                         mesh=mesh)
        else:
            self.FeedForwardBlock_0 = FeedForwardBlock(
                hidden_dim, dtype, mesh if tensor_parallel else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.SelfAttentionBlock_0(x)
        ff = self.moe_ff if hasattr(self, "moe_ff") else self.FeedForwardBlock_0
        return x + ff(x)


class DecoderBlock(nn.Module):
    """x + SA(x); x + CA(x, encoder_output); x + FF(x)."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto",
                 mesh=None, seq_axis=None):
        super().__init__()
        self.SelfAttentionBlock_0 = SelfAttentionBlock(hidden_dim, num_heads, dtype,
                                                       attn_impl, mesh, seq_axis)
        self.CrossAttentionBlock_0 = CrossAttentionBlock(hidden_dim, num_heads, dtype,
                                                         attn_impl, mesh, seq_axis)
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
