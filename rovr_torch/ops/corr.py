"""RAFT-small's correlation lookup: the NUM_LEVELS x (2R+1)^2 bilinear taps
of the all-pairs correlation pyramid around each flow coordinate, in one
CUDA launch a refinement iteration (csrc/corr_lookup.cu).

It replaces no Pallas kernel: the JAX file (rovr_tpu/models/raft.py,
`lookup_corr`) samples the volume as one-hot products that XLA lowers by
itself. `lookup_corr` here is the plain version, stock tensor ops: an index
gather with a validity mask per corner, bilinear with zero padding outside
the level, as the JAX file's one-hot products compute it. On the card it
makes some 85 launches a level over (B, H*W, 49) tensors of indices, masks
and corners; the kernel keeps them in registers and reads each position's
window of each level once.

What bounds the kernel on an H100: device memory. At the main shape (128
frame pairs, 32 x 32 positions, levels 32/16/8/4) the least it must move is
the coordinates (1.05 MB), an 8 x 8 window of each level per position in f32
(134.2 MB) and the bf16 output (51.4 MB): 186.6 MB, 0.0557 ms at 3.35 TB/s.
The design is in the source's note; it computes the plain version's f32 sum
in the plain version's order, rounded once to the output dtype.

`corr_lookup(pyramid, coords, dtype)` launches the kernel for CUDA tensors
(contiguous f32 levels as `correlation_pyramid` returns them, contiguous f32
coordinates, no gradient: RAFT is frozen and the kernel is forward only;
anything else raises) and adds one to `corr_lookup.launches`; CPU and `meta`
tensors run `lookup_corr`. There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from rovr_torch.ops import cuda_build

_SOURCE = "corr_lookup"
NUM_LEVELS = 4
RADIUS = 3
CHANNELS = NUM_LEVELS * (2 * RADIUS + 1) ** 2
OUT_DTYPES = (torch.bfloat16, torch.float32)


def _bilinear_lookup(vol: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample vol (B, N, H, W) at float coordinates ys/xs (B, N, K):
    bilinear, zero outside the volume."""
    b, n, h, w = vol.shape
    if h == 0 or w == 0:  # a level pooled to nothing contributes zeros
        return ys.new_zeros(ys.shape)
    flat = vol.reshape(b, n, h * w)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        return torch.gather(flat, 2, idx) * valid

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


def lookup_corr(pyramid: List[torch.Tensor], coords: torch.Tensor) -> torch.Tensor:
    """The plain version: radius-RADIUS lookup at `coords` (B, H, W, 2 [x,
    y]) across the pyramid -> (B, H, W, NUM_LEVELS * (2R+1)^2) f32 motion
    features, channel l*49 + (dy+3)*7 + (dx+3)."""
    b, h, w, _ = coords.shape
    n, k = h * w, 2 * RADIUS + 1
    r = torch.arange(-RADIUS, RADIUS + 1, dtype=torch.float32, device=coords.device)
    offs_y = r.repeat_interleave(k)   # the JAX meshgrid's "ij" order
    offs_x = r.repeat(k)
    out = []
    for lvl, vol in enumerate(pyramid):
        c = coords.reshape(b, n, 2) / (2.0 ** lvl)
        ys = c[..., 1:2] + offs_y
        xs = c[..., 0:1] + offs_x
        out.append(_bilinear_lookup(vol, ys, xs))
    return torch.cat(out, dim=-1).reshape(b, h, w, NUM_LEVELS * k * k)


def check_kernel_args(pyramid, coords, dtype) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"corr_lookup: coords (B,H,W,2), got {tuple(coords.shape)}")
    b, h, w, _ = coords.shape
    if b * h * w == 0:
        raise ValueError(f"corr_lookup kernel needs 0 < B*H*W, got {tuple(coords.shape)}")
    if len(pyramid) != NUM_LEVELS:
        raise ValueError(f"corr_lookup: {NUM_LEVELS} levels, got {len(pyramid)}")
    if dtype not in OUT_DTYPES:
        raise TypeError(f"corr_lookup kernel writes bf16 or f32, not {dtype}")
    for lvl, t in enumerate((coords, *pyramid)):
        name = "coords" if lvl == 0 else f"level {lvl - 1}"
        if t.dtype != torch.float32:
            raise TypeError(f"corr_lookup kernel takes f32 {name}, got {t.dtype}")
        if t.device != coords.device:
            raise ValueError(f"corr_lookup: {name} is on {t.device}, coords on {coords.device}")
        if not t.is_contiguous():
            raise ValueError(f"corr_lookup kernel needs a contiguous {name}")
        if t.requires_grad:
            raise ValueError(f"corr_lookup kernel is forward only: {name} requires grad")
    for lvl, vol in enumerate(pyramid):
        want = (b, h * w, h >> lvl, w >> lvl)
        if tuple(vol.shape) != want:
            raise ValueError(f"corr_lookup: level {lvl} {tuple(vol.shape)} does not fit "
                             f"coords {tuple(coords.shape)}: want {want}")


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SOURCE)
    fn = lib.rovr_corr_lookup
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 8 + [ctypes.c_longlong, p, i, p]
        fn.restype = ctypes.c_int
        lib.rovr_corr_error_string.argtypes = [ctypes.c_int]
        lib.rovr_corr_error_string.restype = ctypes.c_char_p
    return lib


def corr_lookup(pyramid: List[torch.Tensor], coords: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """`lookup_corr(pyramid, coords)` in `dtype` as (B, 196, H, W) with the
    strides of a permuted (B, H, W, 196): the 196 channels of a position
    contiguous, the layout the motion encoder's first conv takes. A CUDA
    coords launches the kernel and adds one to `corr_lookup.launches`; CPU
    and `meta` tensors run the plain version."""
    if coords.device.type in ("cpu", "meta"):
        return lookup_corr(pyramid, coords).permute(0, 3, 1, 2).to(dtype)
    if coords.device.type != "cuda":
        raise ValueError(f"corr_lookup runs on cuda, cpu or meta, got {coords.device}")
    check_kernel_args(pyramid, coords, dtype)
    b, h, w, _ = coords.shape
    out = torch.empty((b, h, w, CHANNELS), dtype=dtype, device=coords.device)
    sizes = [n for vol in pyramid for n in vol.shape[2:]]
    lib = _lib()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rovr_corr_lookup(coords.data_ptr(), *(v.data_ptr() for v in pyramid),
                                   *sizes, b * h * w, out.data_ptr(),
                                   int(dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError("corr_lookup launch failed: "
                           + lib.rovr_corr_error_string(err).decode())
    corr_lookup.launches += 1
    return out.permute(0, 3, 1, 2)


corr_lookup.launches = 0
