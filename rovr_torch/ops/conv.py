"""K1: fused 3x3 conv (stride 1, SAME) + bias + ReLU, NHWC, for the UNet.

Replaces `rovr_tpu/ops/pallas/conv.py::_conv_kernel` (reached through
`_forward` and the public `fused_conv3x3`): y = relu(conv3x3_same(x, W) + b)
with x NHWC (B,H,W,Cin), W HWIO (3,3,Cin,Cout) in x's dtype, b (Cout,) f32,
accumulated in f32, bias and ReLU in f32, cast back to x's dtype.

What bounds it on an H100: at the serving shapes (batch 8 at 256^2 frames:
conv3 (8,64,64,128)->256, conv4 (8,32,32,256)->512, conv5 (8,64,64,512)->256)
it does 19-77 GFLOP per call on 8-53 MB of operands, some 1,400-2,900
operations per byte, far above the card's ~295 bf16 operations per byte of
device memory: the tensor cores bound it, not memory.

What the design does about that (csrc/fused_conv3x3.cu): an implicit GEMM
(M = output pixels, N = Cout, K = 9*Cin) fed to Hopper's tensor cores the
way they run fastest. `wgmma` multiplies bf16 into f32 accumulators held in
registers (two consumer warpgroups, a 128 x 256 output tile). A
block's 128 output pixels are a TH x TW rectangle of one image, so each
(tap, 64-channel slice) of the A operand is a single 4-D TMA box of the
unpadded NHWC input, and TMA fills the halo, a ragged edge and channels past
Cin with zeros: no padded copy, none of the nine materialized shift views the
TPU kernel needed, no address arithmetic in the loop. The HWIO weights are
read as they are (wgmma's transpose-B). One producer thread keeps a 4-stage
ring of such tiles in flight with mbarriers. Bias and ReLU run on the f32
accumulators before the single bf16 store. Its times stand beside the bound
and cuDNN's in PERF.md.

`fused_conv3x3` launches the kernel for a CUDA tensor and uses the plain
version `fused_conv3x3_plain` only for a CPU tensor. There is no fallback: a
CUDA input the kernel does not take raises.

The backward (`fused_conv3x3_backward`, the same code on every device) is
the stock convolution gradient in the compute dtype (cuDNN on the card), as
the TPU op's backward is XLA's vjp of a plain conv in x's dtype
(rovr_tpu/ops/pallas/conv.py:169-207): no Pallas kernel to port. The forward
saves its output y; the ReLU mask is y > 0 (JAX's `maximum` vjp halves the
gradient at an exact tie y == 0, a set of measure zero).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rovr_torch.ops import cuda_build
from rovr_torch.utils.profiling import annotate

_SOURCE = "fused_conv3x3"


def fused_conv3x3_plain(x, kernel, bias, relu: bool = True):
    """The plain version: the sum of nine shifted (B*H*W, Cin) x (Cin, Cout)
    products in f32, then bias and ReLU in f32, cast back to x's dtype.
    The kernel is rounded to x's dtype first, as the TPU op casts it."""
    with annotate("fused_conv3x3_plain"):  # a profiler trace shows its use
        b, h, w, cin = x.shape
        cout = kernel.shape[-1]
        k = kernel.to(x.dtype).float()
        xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
        acc = None
        for dy in range(3):
            for dx in range(3):
                tap = xp[:, dy:dy + h, dx:dx + w, :].reshape(-1, cin) @ k[dy, dx]
                acc = tap if acc is None else acc + tap
        acc = acc + bias.float()
        if relu:
            acc = torch.relu(acc)
        return acc.reshape(b, h, w, cout).to(x.dtype)


def fused_conv3x3_backward(x, kernel, y, g, relu: bool = True):
    """Gradients (gx, gk, gb) of y = fused_conv3x3(x, kernel, bias, relu)
    for the output gradient g, from the saved output y.

    The conv's gradients are `aten.convolution_backward` in x's dtype on the
    NHWC tensors viewed as channels-last NCHW (cuDNN on the card, f32
    accumulation): gx in x's dtype, gk in the kernel's dtype (HWIO); gb is
    the f32 sum of the masked g. Adds one to `fused_conv3x3.backward_calls`."""
    with annotate("fused_conv3x3_backward"):
        dt = x.dtype
        gm = g.to(dt)
        if relu:
            gm = torch.where(y > 0, gm, torch.zeros((), dtype=dt, device=gm.device))
        gb = gm.sum((0, 1, 2), dtype=torch.float32)
        gx, gw, _ = torch.ops.aten.convolution_backward(
            gm.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
            kernel.to(dt).permute(3, 2, 0, 1), None, [1, 1], [1, 1], [1, 1], False,
            [0, 0], 1, [True, True, False])
        fused_conv3x3.backward_calls += 1
        return (gx.permute(0, 2, 3, 1), gw.permute(2, 3, 1, 0).to(kernel.dtype), gb)


def check_kernel_args(x, kernel, bias) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.dim() != 4 or kernel.dim() != 4 or bias.dim() != 1:
        raise ValueError(
            f"fused_conv3x3: x (B,H,W,Cin), kernel (3,3,Cin,Cout), bias (Cout,);"
            f" got {tuple(x.shape)}, {tuple(kernel.shape)}, {tuple(bias.shape)}"
        )
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    if tuple(kernel.shape) != (3, 3, cin, cout) or bias.shape[0] != cout:
        raise ValueError(
            f"fused_conv3x3: kernel {tuple(kernel.shape)} / bias "
            f"{tuple(bias.shape)} do not fit x {tuple(x.shape)}"
        )
    if x.dtype != torch.bfloat16 or kernel.dtype != torch.bfloat16:
        raise TypeError(
            f"fused_conv3x3 kernel takes bf16 x and kernel, got {x.dtype}, "
            f"{kernel.dtype}"
        )
    if bias.dtype != torch.float32:
        raise TypeError(f"fused_conv3x3 kernel takes an f32 bias, got {bias.dtype}")
    if cin % 8 or cout % 8:  # TMA's global strides are multiples of 16 bytes
        raise ValueError(
            f"fused_conv3x3 kernel needs Cin and Cout divisible by 8, got "
            f"{cin}, {cout}"
        )
    if b * h * w == 0 or b * h * w >= 2 ** 31:
        raise ValueError(f"fused_conv3x3 kernel needs 0 < B*H*W < 2^31, got {b * h * w}")
    for name, t in (("x", x), ("kernel", kernel), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"fused_conv3x3 kernel needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_conv3x3 kernel needs a 16-byte aligned {name}")
        if t.device != x.device:
            raise ValueError(f"fused_conv3x3: {name} is on {t.device}, x on {x.device}")


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SOURCE)
    fn = lib.rovr_fused_conv3x3_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.rovr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rovr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, kernel, bias, relu: bool):
    check_kernel_args(x, kernel, bias)
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    lib = _lib()
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rovr_fused_conv3x3_bf16(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), y.data_ptr(),
            b, h, w, cin, cout, int(relu), stream,
        )
    if err:
        raise RuntimeError(
            "fused_conv3x3 launch failed: "
            + lib.rovr_cuda_error_string(err).decode()
        )
    fused_conv3x3.launches += 1
    return y


def fused_conv3x3_backward_plain(x, kernel, y, g, relu: bool = True):
    """The f32 reference of `fused_conv3x3_backward` on the same inputs:
    autograd of the plain conv (bias, no ReLU) for g masked by the saved
    output, so both apply the same ReLU mask. (The bf16 kernel and the f32
    plain forward sum in other orders and can round a pre-activation within
    ~1e-6 of zero to opposite signs; such a flip moves whole gradient
    terms and says nothing of the backward's precision.) Returns (gx, gk,
    gb) in f32. Nothing in the port calls it."""
    with torch.enable_grad():
        xs, ks = (t.detach().float().requires_grad_() for t in (x, kernel))
        bs = torch.zeros(kernel.shape[-1], device=x.device, requires_grad=True)
        gm = g.float()
        if relu:
            gm = torch.where(y > 0, gm, torch.zeros((), device=gm.device))
        out = fused_conv3x3_plain(xs, ks, bs, False)
        return torch.autograd.grad(out, (xs, ks, bs), gm)


class _FusedConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias, relu):
        if x.device.type == "cpu":
            y = fused_conv3x3_plain(x, kernel, bias, relu)
        elif x.device.type == "cuda":
            y = _launch(x, kernel, bias, relu)
        else:
            raise ValueError(f"fused_conv3x3 runs on cuda or cpu, got {x.device}")
        ctx.save_for_backward(x, kernel, y)
        ctx.relu = relu
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, kernel, y = ctx.saved_tensors
        gx, gk, gb = fused_conv3x3_backward(x, kernel, y, g, ctx.relu)
        return gx, gk, gb.to(ctx.bias_dtype), None


def fused_conv3x3(x, kernel, bias, relu: bool = True):
    """y = relu(conv3x3_same(x, kernel) + bias), NHWC / HWIO.

    x (B,H,W,Cin); kernel (3,3,Cin,Cout); bias (Cout,). A CUDA x launches
    the kernel (bf16 x and kernel, f32 bias; anything else raises) and adds
    one to `fused_conv3x3.launches`; a CPU x runs the plain version. The
    backward is `fused_conv3x3_backward` on either device."""
    return _FusedConv3x3.apply(x, kernel, bias, relu)


fused_conv3x3.launches = 0
fused_conv3x3.backward_calls = 0
