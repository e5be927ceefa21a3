"""Plain float32 reference of RAFT-small, the optical flow network behind the
spatio reward's flow metric φ, written from the paper (Teed & Deng, "RAFT:
Recurrent All-Pairs Field Transforms for Optical Flow", ECCV 2020,
arXiv:2003.12039; its "small" configuration, torchvision's `raft_small`)
and independent of the code it checks.

- Feature encoder: 7x7/2 conv to 32, then bottleneck blocks of 32, 64 (/2)
  and 96 (/2) channels, two each, and a 1x1 conv to 128: features at 1/8
  resolution, every conv but the last followed by instance norm. The
  context encoder is the same with no norm and 160 outputs: 96 hidden
  (tanh) and 64 context (relu).
- All-pairs correlation: one product of the two frames' features over
  sqrt(128), then a 4-level pyramid of 2x2 average pools (`F.avg_pool2d`).
- Lookup: at each level, the 7x7 window of radius 3 around the current
  coordinates / 2^level, sampled by `F.grid_sample` (bilinear, zero
  padding, `align_corners=True`), as the published code does.
- Update, 12 times with one set of weights: the small motion encoder (1x1
  corr conv to 96; 7x7 and 3x3 flow convs to 64, 32; a 3x3 conv to 80;
  the flow appended), a ConvGRU(96) over [context, motion], and the flow
  head (3x3 to 128, 3x3 to 2), whose output moves the coordinates.
- The last iteration's flow, upsampled 8x.

Where it follows the JAX package (and so the port) rather than the
published code:
- the 8x upsampling is `jax.image.resize`'s bilinear with half-pixel
  centres (`align_corners=False`); torchvision upsamples with
  `align_corners=True`;
- the 49 lookup offsets are in the JAX package's "ij" order: row offset
  outer, column offset inner, each added to its own coordinate (the
  published code stacks meshgrid(dy, dx) and adds the first to x);
- the instance norms have a learned scale and bias (flax's InstanceNorm;
  the published ones have none);
- a pyramid level pooled to nothing (an input under 64 pixels a side)
  contributes zeros.

Parameters are read by the port's state-dict names (`fnet`, `cnet`,
`update.motion`, `update.gru`, `update.flow_head`; OIHW convs with biases),
as the benchmark draws them. Every conv and the correlation product go
through `model.Precision`. Pairs run in blocks of `BLOCK`.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from . import model as M

NUM_LEVELS = 4
RADIUS = 3
HIDDEN, CONTEXT, FEATURES = 96, 64, 128
ITERS = 12
BLOCK = 128          # frame pairs a block
ENCODER = ((1, 32, 1), (2, 64, 2), (3, 96, 2))     # (layer, channels, stride)


def param_shapes() -> Dict[str, Tuple[int, ...]]:
    """name -> shape of every parameter the reference reads."""
    out: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cin, cout, k):
        out[f"{name}.weight"], out[f"{name}.bias"] = (cout, cin, k, k), (cout,)

    def norm(name, c):
        out[f"{name}.weight"], out[f"{name}.bias"] = (c,), (c,)

    for enc, dim, normed in (("fnet", FEATURES, True), ("cnet", HIDDEN + CONTEXT, False)):
        conv(f"{enc}.conv1", 3, 32, 7)
        if normed:
            norm(f"{enc}.norm1", 32)
        cin = 32
        for layer, f, stride in ENCODER:
            for blk in range(2):
                pre = f"{enc}.layer{layer}_{blk}"
                c_in = cin if blk == 0 else f
                for j, (ci, co, k) in enumerate(((c_in, f // 4, 1), (f // 4, f // 4, 3),
                                                 (f // 4, f, 1))):
                    conv(f"{pre}.conv{j + 1}", ci, co, k)
                    if normed:
                        norm(f"{pre}.norm{j + 1}", co)
                if blk == 0 and (stride != 1 or c_in != f):
                    conv(f"{pre}.conv_down", c_in, f, 1)
                    if normed:
                        norm(f"{pre}.norm_down", f)
            cin = f
        conv(f"{enc}.conv2", 96, dim, 1)
    taps = NUM_LEVELS * (2 * RADIUS + 1) ** 2
    conv("update.motion.convc1", taps, 96, 1)
    conv("update.motion.convf1", 2, 64, 7)
    conv("update.motion.convf2", 64, 32, 3)
    conv("update.motion.conv", 128, 80, 3)
    for g in ("convz", "convr", "convq"):
        conv(f"update.gru.{g}", HIDDEN + CONTEXT + 82, HIDDEN, 3)
    conv("update.flow_head.conv1", HIDDEN, 128, 3)
    conv("update.flow_head.conv2", 128, 2, 3)
    return out


def _conv(P: M.Precision, p: M.Params, name: str, x: torch.Tensor, stride: int = 1):
    w = p[f"{name}.weight"]
    return P.conv(x, w, p[f"{name}.bias"], stride, w.shape[-1] // 2)


def _instance_norm(p: M.Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.instance_norm(x, weight=p[f"{name}.weight"].float(),
                           bias=p[f"{name}.bias"].float(), eps=1e-5)


def encoder(P: M.Precision, p: M.Params, x: torch.Tensor, normed: bool) -> torch.Tensor:
    """(N, 3, H, W) in [-1, 1] -> (N, C, H/8, W/8)."""
    def norm(name, y):
        return _instance_norm(p, name, y) if normed else y

    x = torch.relu(norm("norm1", _conv(P, p, "conv1", x, 2)))
    for layer, _, stride in ENCODER:
        for blk in range(2):
            pre, s = f"layer{layer}_{blk}", stride if blk == 0 else 1
            y = torch.relu(norm(f"{pre}.norm1", _conv(P, p, f"{pre}.conv1", x)))
            y = torch.relu(norm(f"{pre}.norm2", _conv(P, p, f"{pre}.conv2", y, s)))
            y = torch.relu(norm(f"{pre}.norm3", _conv(P, p, f"{pre}.conv3", y)))
            if f"{pre}.conv_down.weight" in p:
                x = norm(f"{pre}.norm_down", _conv(P, p, f"{pre}.conv_down", x, s))
            x = torch.relu(x + y)
    return _conv(P, p, "conv2", x)


def pyramid(P: M.Precision, f1: torch.Tensor, f2: torch.Tensor):
    """Features (N, D, h, w) of both frames -> NUM_LEVELS volumes
    (N*h*w, 1, h/2^l, w/2^l): every pixel of frame 1 against frame 2."""
    n, d, h, w = f1.shape
    corr = P.matmul(f1.flatten(2).transpose(1, 2), f2.flatten(2)) / math.sqrt(d)
    levels = [corr.reshape(n * h * w, 1, h, w)]
    for _ in range(NUM_LEVELS - 1):
        c = levels[-1]
        if min(c.shape[2:]) < 2:    # pooled to nothing
            c = c[:, :, :c.shape[2] // 2, :c.shape[3] // 2]
        else:
            c = F.avg_pool2d(c, 2)
        levels.append(c)
    return levels


def _sample(vol: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """vol (M, 1, H, W) at pixel coordinates xs, ys (M, k, k): bilinear,
    zero outside."""
    hh, ww = vol.shape[2:]
    if hh == 0 or ww == 0:
        return xs.new_zeros(xs.shape)
    # align_corners=True puts -1 and 1 on the first and last pixel centres,
    # which a side of one pixel cannot tell apart: give it a zero pixel,
    # which is what zero padding reads there anyway
    if hh == 1 or ww == 1:
        vol = F.pad(vol, (0, int(ww == 1), 0, int(hh == 1)))
        hh, ww = vol.shape[2:]
    grid = torch.stack([2.0 * xs / (ww - 1) - 1.0, 2.0 * ys / (hh - 1) - 1.0], -1)
    return F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)[:, 0]


def lookup(levels, coords: torch.Tensor) -> torch.Tensor:
    """coords (N, 2 [x, y], h, w) -> (N, NUM_LEVELS * 49, h, w)."""
    n, _, h, w = coords.shape
    r = torch.arange(-RADIUS, RADIUS + 1, dtype=torch.float32, device=coords.device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    centre = coords.permute(0, 2, 3, 1).reshape(n * h * w, 1, 1, 2)
    out = []
    for lvl, vol in enumerate(levels):
        c = centre / 2 ** lvl
        out.append(_sample(vol, c[..., 0] + dx, c[..., 1] + dy).reshape(n, h, w, -1))
    return torch.cat(out, -1).permute(0, 3, 1, 2)


def update(P: M.Precision, p: M.Params, hid, context, corr, flow):
    """One refinement: (hidden, delta flow)."""
    c = torch.relu(_conv(P, p, "motion.convc1", corr))
    f = torch.relu(_conv(P, p, "motion.convf1", flow))
    f = torch.relu(_conv(P, p, "motion.convf2", f))
    motion = torch.relu(_conv(P, p, "motion.conv", torch.cat([c, f], 1)))
    x = torch.cat([context, motion, flow], 1)
    hx = torch.cat([hid, x], 1)
    z = torch.sigmoid(_conv(P, p, "gru.convz", hx))
    r = torch.sigmoid(_conv(P, p, "gru.convr", hx))
    q = torch.tanh(_conv(P, p, "gru.convq", torch.cat([r * hid, x], 1)))
    hid = (1 - z) * hid + z * q
    return hid, _conv(P, p, "flow_head.conv2", torch.relu(_conv(P, p, "flow_head.conv1", hid)))


def flow(P: M.Precision, p: M.Params, img1: torch.Tensor, img2: torch.Tensor,
         iters: int = ITERS) -> torch.Tensor:
    """Frames (N, H, W, 3) in [0, 1] -> flow (N, H, W, 2) from 1 to 2."""
    n, hh, ww, _ = img1.shape
    x1, x2 = ((2.0 * x.float() - 1.0).permute(0, 3, 1, 2) for x in (img1, img2))
    fmaps = encoder(P, M.sub(p, "fnet"), torch.cat([x1, x2]), True)
    cmap = encoder(P, M.sub(p, "cnet"), x1, False)
    hid, context = torch.tanh(cmap[:, :HIDDEN]), torch.relu(cmap[:, HIDDEN:])
    levels = pyramid(P, fmaps[:n], fmaps[n:])
    h, w = fmaps.shape[2:]
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x1.device),
                            torch.arange(w, dtype=torch.float32, device=x1.device),
                            indexing="ij")
    coords0 = torch.stack([gx, gy])[None].expand(n, 2, h, w)
    coords1 = coords0
    up = M.sub(p, "update")
    for _ in range(iters):
        hid, delta = update(P, up, hid, context, lookup(levels, coords1), coords1 - coords0)
        coords1 = coords1 + delta
    flow8 = coords1 - coords0
    return 8.0 * F.interpolate(flow8, size=(hh, ww), mode="bilinear",
                               align_corners=False).permute(0, 2, 3, 1)


def flow_size(cfg: dict) -> int:
    """RAFT's input size: the configuration's `spatio_flow_size`, no larger
    than the frames' smaller side."""
    return min(cfg["rl"]["spatio_flow_size"], *cfg["data"]["frame_size"])


def _resize(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, 3) -> (N, size, size, 3): bilinear, half-pixel centres,
    antialiased when it shrinks."""
    h, w = frames.shape[1:3]
    y = F.interpolate(frames.permute(0, 3, 1, 2).float(), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=(size < h or size < w))
    return y.permute(0, 2, 3, 1)


def phi(P: M.Precision, p: M.Params, clips: torch.Tensor, size: int,
        iters: int = ITERS) -> torch.Tensor:
    """Clips (B, S, H, W, 3) in [0, 1] -> (B,): the flow magnitude
    sqrt(sum flow^2) of each pair of consecutive frames at size x size,
    summed over the clip's pairs."""
    b, s = clips.shape[:2]
    small = _resize(clips.reshape((b * s,) + tuple(clips.shape[2:])), size)
    small = small.reshape(b, s, size, size, 3)
    f1 = small[:, :-1].reshape(-1, size, size, 3)
    f2 = small[:, 1:].reshape(-1, size, size, 3)
    mags = [flow(P, p, f1[i:i + BLOCK], f2[i:i + BLOCK], iters).square().sum((1, 2, 3)).sqrt()
            for i in range(0, f1.shape[0], BLOCK)]
    return torch.cat(mags).reshape(b, s - 1).sum(1)


def spatio(P: M.Precision, p: M.Params, recon: torch.Tensor, org: torch.Tensor,
           corrupted: torch.Tensor, size: int, scale: float,
           iters: int = ITERS) -> torch.Tensor:
    """(B,): (1 - |φ(recon) - φ(org)| / |φ(corrupted) - φ(org)|) * scale."""
    r, o, c = (phi(P, p, x, size, iters) for x in (recon, org, corrupted))
    return (1.0 - (r - o).abs() / (c - o).abs()) * scale


def pair_flops(size: int, iters: int = ITERS) -> float:
    """FLOPs of one frame pair at size x size (FlopCounterMode on the meta
    device: the convs and the correlation product)."""
    p = {k: torch.empty(s, device="meta") for k, s in param_shapes().items()}
    x = torch.empty(1, size, size, 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        flow(M.Precision("f32"), p, x, x, iters)
    return float(counter.get_total_flops())
