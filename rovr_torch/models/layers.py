"""Shared building blocks of the port's model zoo (rovr_tpu/models/layers.py).

Layout: modules take and return NCHW logical tensors. The public functions
of the model files keep the JAX package's NHWC layout and permute at their
boundary, which on a contiguous NHWC tensor yields NCHW in channels_last
memory: cuDNN's preferred layout, and exactly the NHWC buffer K1 reads.

Parameters stay float32; each conv casts its input and weights to its
compute dtype, as flax's `dtype=` does.

BatchStatNorm keeps the JAX package's semantics: it normalizes by the
CURRENT batch statistics (train-mode BatchNorm forever, biased variance) and
holds no running state. Its backward is written out (`_BatchStatNormFn`): it
saves the input in its own dtype and the per-channel mean and rstd, where
autograd of the f32 formula would save three f32 copies of the activation
(at PolicyNet1's PPO batch, 512 canvases of 256^2, each is 4.3 GB per
32-channel map).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rovr_torch.ops import conv as k1
from rovr_torch.parallel import collectives


class _BatchStatNormFn(torch.autograd.Function):
    """y = (x - mean) * rsqrt(var + eps) * weight + bias over `dims` (f32
    math, the forward exactly as BatchStatNorm's formula), saving x in its
    own dtype and the f32 mean and rstd; the backward recomputes
    xhat from them.

    Under a data mesh the statistics are the global batch's: the forward
    all-reduces the per-channel sums of x and x^2 and the count, the
    backward the sums behind its two means m1 and m2 (one call each). Each
    rank's backward then carries its shard's part of the global loss's
    gradient times the mesh size, which the optimiser's gradient mean
    divides out (parallel.collectives)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dims, out_dtype, mesh=None):
        x32 = x.float()
        if mesh is None:
            mean = x32.mean(dims, keepdim=True)
            var = (x32 * x32).mean(dims, keepdim=True) - mean * mean
        else:
            mean, ex2 = _global_means(mesh, dims, x32, x32 * x32)
            var = ex2 - mean * mean
        rstd = torch.rsqrt(var + eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = (x32 - mean) * rstd * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.dims = dims
        ctx.mesh = mesh
        return y.to(out_dtype)

    @staticmethod
    def backward(ctx, grad):
        x, weight, mean, rstd = ctx.saved_tensors
        shape = (1, -1) + (1,) * (x.dim() - 2)
        pdims = (0,) + tuple(range(2, x.dim()))    # every axis but channels
        xhat = x.float().sub_(mean).mul_(rstd)
        g = grad.float()
        gw = (g * xhat).sum(pdims) if ctx.needs_input_grad[1] else None
        gb = g.sum(pdims) if ctx.needs_input_grad[2] else None
        gx = None
        if ctx.needs_input_grad[0]:
            g.mul_(weight.view(shape))              # d/d xhat
            if ctx.mesh is None:
                m1 = g.mean(ctx.dims, keepdim=True)
                m2 = (g * xhat).mean(ctx.dims, keepdim=True)
            else:
                m1, m2 = _global_means(ctx.mesh, ctx.dims, g, g * xhat)
            gx = g.sub_(m1).sub_(xhat.mul_(m2)).mul_(rstd).to(x.dtype)
        return gx, gw, gb, None, None, None, None


def _global_means(mesh, dims, *ts):
    """The means over `dims` of each of `ts` across every rank of `mesh`
    (keepdim), from one all-reduce of their sums and the element count."""
    sums = [t.sum(dims, keepdim=True) for t in ts]
    count = math.prod(ts[0].shape[d] for d in dims)
    flat = torch.cat([s.reshape(-1) for s in sums]
                     + [sums[0].new_full((1,), float(count))])
    flat = collectives.all_reduce_(flat, mesh)
    parts = flat[:-1].split([s.numel() for s in sums])
    return [p.view_as(s) / flat[-1] for p, s in zip(parts, sums)]


class BatchStatNorm(nn.Module):
    """Normalize by current batch statistics over every axis but channels
    (axis 1): var = E[x^2] - E[x]^2, eps 1e-5, f32 math.

    `per_sample=True` leaves the batch axis out of the statistics, so a
    sample's output does not depend on its batchmates. Otherwise, inside
    `parallel.collectives.global_batch(mesh)`, the statistics cover every
    rank's batch."""

    init_as_constructed = True   # flax_init_state: ones and zeros

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, per_sample: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.eps = eps
        self.dtype = dtype
        self.per_sample = per_sample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.per_sample and x.dim() < 3:
            raise ValueError(
                "per_sample stats need at least one non-batch reduction axis"
            )
        dims = tuple(range(2, x.dim()))
        mesh = None
        if not self.per_sample:
            dims = (0,) + dims
            mesh = collectives.current_mesh()
        return _BatchStatNormFn.apply(x, self.weight, self.bias, self.eps, dims,
                                      x.dtype if self.dtype is None else self.dtype, mesh)


def max_pool(
    x: torch.Tensor,
    window: Tuple[int, int],
    strides: Optional[Tuple[int, int]] = None,
    padding: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None,
) -> torch.Tensor:
    """NCHW max pool, VALID over the (optionally -inf-padded) input, as the
    JAX package's `max_pool`. A window larger than the input gives an empty
    output, as flax does, where torch's pool would raise."""
    strides = tuple(strides or window)
    window = tuple(window)
    (pt, pb), (pl, pr) = padding or ((0, 0), (0, 0))
    h, w = x.shape[-2] + pt + pb, x.shape[-1] + pl + pr
    oh = (h - window[0]) // strides[0] + 1
    ow = (w - window[1]) // strides[1] + 1
    if oh <= 0 or ow <= 0:
        return x.new_empty(x.shape[:-2] + (max(oh, 0), max(ow, 0)))
    if pt == pb and pl == pr and 2 * pt <= window[0] and 2 * pl <= window[1]:
        # torch pads a pool with -inf implicitly
        return F.max_pool2d(x, window, strides, padding=(pt, pl))
    x = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(x, window, strides)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `compute_dtype` (None: the input's dtype) with
    float32 parameters, as flax's nn.Conv(dtype=..., param_dtype=f32)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(cdt)
        return F.conv2d(x.to(cdt), self.weight.to(cdt), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d computing in `compute_dtype` with f32 params."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype or x.dtype
        return F.conv_transpose2d(
            x.to(cdt), self.weight.to(cdt), self.bias.to(cdt), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation,
        )


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype` with f32 params, as flax's
    nn.Dense(dtype=..., param_dtype=f32)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """`bias=False`: the product alone (a row-parallel part, whose sum
        over the model axis takes the bias once)."""
        cdt = self.compute_dtype or torch.promote_types(x.dtype, torch.float32)
        return F.linear(x.to(cdt), self.weight.to(cdt), self.bias.to(cdt) if bias else None)


class ConvBlock(nn.Module):
    """conv3x3 (padding 1) -> BatchStatNorm -> ReLU, NCHW; f32 params,
    compute in `dtype` (None: the input's). Submodule names are flax's
    (`Conv_0`, `BatchStatNorm_0`), so JAX weights map by rule."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None, per_sample_stats: bool = False):
        super().__init__()
        self.Conv_0 = Conv2d(in_features, features, 3, padding=1, compute_dtype=dtype)
        self.BatchStatNorm_0 = BatchStatNorm(features, dtype=dtype, per_sample=per_sample_stats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchStatNorm_0(self.Conv_0(x)))


class UpConvBlock(nn.Module):
    """2x2 stride-2 transposed conv (output 2x the input) -> BatchStatNorm
    -> ReLU, NCHW, as ConvBlock (`ConvTranspose_0`, `BatchStatNorm_0`)."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None, per_sample_stats: bool = False):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose2d(in_features, features, 2, stride=2,
                                               compute_dtype=dtype)
        self.BatchStatNorm_0 = BatchStatNorm(features, dtype=dtype, per_sample=per_sample_stats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchStatNorm_0(self.ConvTranspose_0(x)))


class RecurrentLinear(nn.Linear):
    """A recurrent kernel of an LSTM cell: nn.Linear that flax_init_state
    draws orthogonal, as flax's `recurrent_kernel_init`."""


@functools.lru_cache(maxsize=None)
def _s2d_conv_assembly(block: int = 8) -> torch.Tensor:
    """0/1 assembly tensor T[a,b,di,dj,uv,pq] (f32, CPU) mapping a 3x3
    kernel on a 1-channel map to its space-to-depth-`block` form: output
    pixel (block*bi+p, block*bj+q) reads input pixel (block*bi+p+a-1,
    block*bj+q+b-1), which is block (bi+di-1, bj+dj-1) at in-block offset
    (u, v). Zero padding commutes: offsets outside the map land in the s2d
    conv's zero-padded border blocks, as SAME padding has them."""
    bk = block
    t = torch.zeros(3, 3, 3, 3, bk * bk, bk * bk)
    for a in range(3):
        for b in range(3):
            for p in range(bk):
                for q in range(bk):
                    y, x = p + a - 1, q + b - 1
                    di, dj = (y + bk) // bk, (x + bk) // bk
                    t[a, b, di, dj, (y % bk) * bk + (x % bk), p * bk + q] = 1.0
    return t


class CanvasConv3x3(nn.Module):
    """3x3 SAME conv on the policy's canvas trunk (NCHW). `fold_bias_into_norm`
    skips the bias add: a batch-stat norm follows and cancels it exactly,
    and the param stays for the checkpoint structure.

    `packed=True` (a 1-channel input whose H and W divide by `block`)
    computes the same conv as ONE 3x3 conv over block^2-channel
    space-to-depth tiles, with the kernel assembled from `_s2d_conv_assembly`
    (each assembled entry is one kernel value, so the cast to the compute
    dtype is exact). It returns the channel-first counterpart of the JAX
    layout (B, H/b, W/b, b, b, F): (B, F, b, b, H/b, W/b), where
    [n, f, p, q, i, j] is output pixel (b*i + p, b*j + q) of channel f. A
    BatchStatNorm over it sees the same values as over the plain output, and
    a max over axes (2, 3) is the b x b pool."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None,
                 fold_bias_into_norm: bool = False, block: int = 8):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype
        self.fold_bias_into_norm = fold_bias_into_norm
        self.block = block
        lecun_normal_(self.weight)

    def forward(self, x: torch.Tensor, packed: bool = False) -> torch.Tensor:
        cdt = self.dtype or x.dtype
        x = x.to(cdt)
        if not packed:
            y = F.conv2d(x, self.weight.to(cdt), padding=1)
            bias_shape = (1, -1, 1, 1)
        else:
            y = self._packed(x, cdt)
            bias_shape = (1, -1, 1, 1, 1, 1)
        if self.fold_bias_into_norm:
            return y
        return y + self.bias.to(cdt).view(bias_shape)

    def _packed(self, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
        bsz, cin, h, w = x.shape
        bk, f = self.block, self.weight.shape[0]
        if cin != 1:
            raise ValueError("packed path requires a 1-channel input")
        if h % bk or w % bk:
            raise ValueError(f"packed path needs H and W divisible by {bk}, got {h}x{w}")
        hb, wb = h // bk, w // bk
        xs = x.reshape(bsz, hb, bk, wb, bk).permute(0, 2, 4, 1, 3)
        xs = xs.reshape(bsz, bk * bk, hb, wb)              # channel u*bk + v
        t = _s2d_conv_assembly(bk).to(self.weight.device)
        kp = torch.einsum("fab,abdeup->fpude", self.weight[:, 0], t)
        kp = kp.reshape(f * bk * bk, bk * bk, 3, 3)        # out channel f*bk^2 + p*bk + q
        y = F.conv2d(xs, kp.to(cdt), padding=1)
        return y.view(bsz, f, bk, bk, hb, wb)


class FusedConv3x3(nn.Module):
    """conv3x3(same) + bias + ReLU through K1 (rovr_torch/ops/conv.py).

    `impl`: "auto" launches the CUDA kernel for a CUDA input and runs the
    plain version for a CPU input; "kernel" demands the CUDA kernel (a CPU
    input raises); "plain" runs the plain version on any device. The TPU
    op's profitability envelope (`supported`) does not carry over: on CUDA
    the kernel is always used."""

    def __init__(self, in_features: int, features: int, relu: bool = True,
                 dtype: Optional[torch.dtype] = None, impl: str = "auto"):
        super().__init__()
        if impl not in ("auto", "kernel", "plain"):
            raise ValueError(f"impl must be auto, kernel or plain, got {impl!r}")
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        self.relu = relu
        self.dtype = dtype
        self.impl = impl
        lecun_normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.dtype or x.dtype
        xh = x.to(cdt).permute(0, 2, 3, 1).contiguous()       # NHWC
        kernel = self.weight.to(cdt).permute(2, 3, 1, 0).contiguous()  # HWIO
        if self.impl == "plain":
            y = k1.fused_conv3x3_plain(xh, kernel, self.bias, self.relu)
        elif self.impl == "kernel" and not xh.is_cuda:
            raise ValueError("FusedConv3x3(impl='kernel') needs a CUDA input")
        else:
            y = k1.fused_conv3x3(xh, kernel, self.bias, self.relu)
        return y.permute(0, 3, 1, 2)


class MLP(nn.Sequential):
    """Stack of Linear layers with NO activations between them (the policy's
    final_fc chain of bare linears), float32."""

    def __init__(self, in_features: int, dims: Sequence[int]):
        layers = []
        for d in dims:
            layers.append(nn.Linear(in_features, d))
            in_features = d
        super().__init__(*layers)


class LayerNorm(nn.Module):
    """flax's nn.LayerNorm over the last axis: eps 1e-6, statistics in f32
    with var = E[x^2] - E[x]^2 (clipped at 0), f32 output (the f32 params
    promote it), parameters `weight` (flax `scale`) and `bias`."""

    eps = 1e-6
    init_as_constructed = True   # flax_init_state: ones and zeros

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class DenseGeneral(nn.Module):
    """flax's nn.DenseGeneral contracting the input's last len(in_shape)
    axes into out_shape axes. The weight keeps flax's layout
    (*in_shape, *out_shape) and the bias is (*out_shape,), so JAX weights
    carry over as they are. Computes in `dtype` (None: the input's dtype,
    promoted with the f32 params), as flax's `dtype=` does."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.fan_in = math.prod(self.in_shape)
        self.weight = nn.Parameter(torch.empty(self.in_shape + self.out_shape))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))
        self.dtype = dtype
        lecun_normal_(self.weight, self.fan_in)

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """`bias=False`: the product alone, as `Linear`'s."""
        cdt = self.dtype or torch.promote_types(x.dtype, torch.float32)
        batch = x.shape[:x.dim() - len(self.in_shape)]
        w = self.weight.to(cdt).reshape(self.fan_in, -1)
        x2 = x.to(cdt).reshape(-1, self.fan_in)
        y = torch.addmm(self.bias.to(cdt).reshape(-1), x2, w) if bias else x2 @ w
        return y.reshape(batch + self.out_shape)


def reference_tensor(state_dict, name: str) -> torch.Tensor:
    """state_dict[name] (a tensor or an array) as a new float32 CPU tensor:
    the reference converters' read; a missing name raises KeyError."""
    return torch.as_tensor(state_dict[name], dtype=torch.float32, device="cpu").clone()


def standardize(x: torch.Tensor, dim, eps: float, keepdim: bool = True, mesh=None):
    """(x - mean) / (std + eps) with unbiased std; sqrt(var + 1e-12) keeps
    the gradient of a constant column finite (layers.py rationale). With a
    data `mesh` and dim=0 (the batch axis) the mean and the variance are
    the global batch's (ddof 1 over the global count), differentiably."""
    x32 = x.float()
    if mesh is None:
        mean = x32.mean(dim, keepdim=keepdim)
        var = x32.var(dim, keepdim=keepdim, correction=1)
    else:
        if dim != 0:
            raise ValueError("standardize over a mesh reduces the batch axis (dim=0)")
        n = x.shape[0] * mesh.size
        mean = collectives.psum(x32.sum(0, keepdim=True), mesh) / n
        var = collectives.psum(((x32 - mean) ** 2).sum(0, keepdim=True), mesh) / (n - 1)
        if not keepdim:
            mean, var = mean[0], var[0]
    return ((x32 - mean) / (torch.sqrt(var + 1e-12) + eps)).to(x.dtype)


def lecun_normal_(w: torch.Tensor, fan_in: Optional[int] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at +-2 sd, scaled to
    variance 1/fan_in (fan_in defaults to w[0].numel(), right for OIHW convs
    and (out, in) linears)."""
    fan_in = fan_in or w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w.mul_(std)


def flax_init_state(module: nn.Module, generator: torch.Generator) -> dict:
    """Fresh parameters for `module` drawn as the JAX package's flax modules
    draw theirs: lecun-normal conv and linear kernels (a transposed conv's
    fan-in is in*kh*kw, a DenseGeneral's the product of its input axes),
    orthogonal recurrent kernels (`RecurrentLinear`), zero biases, LPIPS
    lins U(0, 0.1), N(0, std) for the parameters a module names in its
    `normal_init` {name: std}, lecun-normal at the fan-in it names in its
    `lecun_init` {name: fan_in} (the MoE's stacked expert kernels), zeros
    for the names in its `zero_init`, and their construction values (ones and
    zeros) for the norms, which say so by `init_as_constructed`. Any other
    parameter raises. A parameter the module holds a part of (its
    `model_shards` {name: (axis, parts, index)}, tensor and expert
    parallelism) is drawn whole and cut to the part, so the parts are those
    of the single-device draw. Returns a state dict on the module's device;
    the module is untouched."""
    out = {}
    for mname, m in module.named_modules():
        own = list(m.named_parameters(recurse=False)) \
            + list(m.named_buffers(recurse=False))
        shards = getattr(m, "model_shards", {})
        for pname, t in own:
            key = f"{mname}.{pname}" if mname else pname
            shape = list(t.shape)
            if pname in shards:
                dim, parts, _ = shards[pname]
                shape[dim] *= parts
            new = torch.empty(shape, dtype=t.dtype)
            conv_like = isinstance(m, (nn.Conv2d, nn.Linear, CanvasConv3x3, FusedConv3x3))
            if pname in getattr(m, "normal_init", {}):
                new.normal_(0.0, m.normal_init[pname], generator=generator)
            elif pname in getattr(m, "lecun_init", {}):
                lecun_normal_(new, m.lecun_init[pname], generator)
            elif pname in getattr(m, "zero_init", ()):
                new.zero_()
            elif pname == "weight" and isinstance(m, RecurrentLinear):
                nn.init.orthogonal_(new, generator=generator)
            elif pname == "weight" and isinstance(m, DenseGeneral):
                lecun_normal_(new, math.prod(shape[:len(m.in_shape)]), generator)
            elif pname == "weight" and isinstance(m, nn.ConvTranspose2d):
                lecun_normal_(new, t.shape[0] * t.shape[2] * t.shape[3], generator)
            elif pname == "weight" and conv_like:
                lecun_normal_(new, None, generator)
            elif pname == "bias" and (conv_like or isinstance(
                    m, (nn.ConvTranspose2d, DenseGeneral))):
                new.zero_()
            elif pname.startswith("lin") and t.dim() == 1:
                new.uniform_(0.0, 0.1, generator=generator)
            elif getattr(m, "init_as_constructed", False):
                new.copy_(t.detach())
            else:
                raise ValueError(f"flax_init_state: no initializer for {key} of "
                                 f"{type(m).__name__}")
            if pname in shards:
                dim, parts, index = shards[pname]
                new = new.chunk(parts, dim)[index].clone()
            out[key] = new.to(t.device)
    return out
