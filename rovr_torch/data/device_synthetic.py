"""Synthetic clips and their corruption made on the device
(rovr_tpu/data/device_synthetic.py, PyTorch port).

The host synthetic path (data/synthetic.py) is numpy-bound; here everything
pixel-sized runs as tensor ops on the GPU: the moving-gradient clips (with
the optional drifting mid-frequency texture), the jittered box masks of the
explicit teacher scheme (video_ds_explicit.py:36-71 geometry) or the
standard raster boxes (video_ds.py:62-87), and their application. The host
contributes only the tiny combinatorial teacher assignment (data/teacher.py)
and the pair tables, as small int arrays.

Each generator is split into a draw step, which takes every random number
from an explicit `torch.Generator` on the device, and a pure function of the
draws (`synthetic_clips_from_draws`, `_explicit_masks`), so the tests can
replay `jax.random`'s draws through the port's math. torch's draws differ
from JAX's, so the sources give clips of the same distribution, not the
same clips.

The sources (`make_source`) have the JAX package's contract: `next(i)` ->
(corrupted, original, masks, positives, negatives), pixels (B, 20, H, W, 3)
float32 in [0, 1] on the device, deterministic per (seed, i); positives and
negatives are host int arrays of the explicit scheme (None for raster).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rovr_torch.data import corruption, teacher
from rovr_torch.device import resolve

TEXTURE_CELL = 8  # px per random texture grid cell


class ClipDraws(NamedTuple):
    """The random numbers behind a batch of synthetic clips (all float32)."""

    phase: torch.Tensor     # (B, 3) in [0, 2 pi)
    speed: torch.Tensor     # (B, 3) in [0.5, 2)
    blob_xy: torch.Tensor   # (B, 4, 2) in [0.2, 0.8)
    blob_v: torch.Tensor    # (B, 4, 2) in [-0.02, 0.02)
    blob_col: torch.Tensor  # (B, 4, 3) in [0.3, 1)
    grid: Optional[torch.Tensor] = None  # (B, gh, gw, 3) in [0, 1): the texture
    vel: Optional[torch.Tensor] = None   # (B, 2) in [-texture_vel, texture_vel)


def texture_margin(num_frames: int, texture_vel: float) -> int:
    """Pixels of texture kept beyond each frame edge for the drift."""
    return int(np.ceil(texture_vel * max(1, num_frames - 1))) + TEXTURE_CELL


def texture_grid_shape(height: int, width: int, num_frames: int,
                       texture_vel: float) -> Tuple[int, int]:
    """(gh, gw) cells of the random texture grid."""
    m = texture_margin(num_frames, texture_vel)
    return ((height + 2 * m) // TEXTURE_CELL + 2, (width + 2 * m) // TEXTURE_CELL + 2)


def draw_clips(generator: torch.Generator, batch: int, height: int, width: int,
               num_frames: int = teacher.NUM_FRAMES, texture: float = 0.0,
               texture_vel: float = 1.5) -> ClipDraws:
    """Every random number of `synthetic_clips`, on the generator's device."""
    dev = generator.device

    def uniform(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    d = ClipDraws(uniform((batch, 3), 0.0, 2 * np.pi), uniform((batch, 3), 0.5, 2.0),
                  uniform((batch, 4, 2), 0.2, 0.8), uniform((batch, 4, 2), -0.02, 0.02),
                  uniform((batch, 4, 3), 0.3, 1.0))
    if texture > 0.0:
        gh, gw = texture_grid_shape(height, width, num_frames, texture_vel)
        d = d._replace(grid=uniform((batch, gh, gw, 3)),
                       vel=uniform((batch, 2), -texture_vel, texture_vel))
    return d


def synthetic_clips_from_draws(d: ClipDraws, height: int, width: int,
                               num_frames: int = teacher.NUM_FRAMES,
                               texture: float = 0.0,
                               texture_vel: float = 1.5) -> torch.Tensor:
    """(B, S, H, W, 3) float32 in [0, 1]: moving gradients + drifting blobs
    (the device twin of synthetic.synthetic_clip), the same f32 operations
    in the same order as the JAX function (device_synthetic.py:30-111).

    `texture` > 0 blends in a per-clip mid-frequency random pattern (the
    8-px random grid upsampled bilinearly, rigidly drifting up to
    `texture_vel` px/frame), which makes context selection learnable: it is
    unpredictable across a masked box yet copyable from any frame that
    exposes the region. `texture_vel=0` makes it static."""
    dev = d.phase.device
    b = d.phase.shape[0]
    ys = (torch.arange(height, dtype=torch.float32, device=dev) / height)[:, None]
    xs = (torch.arange(width, dtype=torch.float32, device=dev) / width)[None, :]
    t = torch.arange(num_frames, dtype=torch.float32, device=dev)
    tt = t[None, :, None, None, None]                 # (1, S, 1, 1, 1)
    sp = d.speed[:, None, None, None, :]              # (B, 1, 1, 1, 3)
    ph = d.phase[:, None, None, None, :]
    img = 0.5 + 0.4 * torch.sin(
        2 * np.pi * (xs[None, None, :, :, None] + 0.01 * sp * tt) + ph
    ) * torch.cos(2 * np.pi * (ys[None, None, :, :, None] - 0.013 * sp * tt))
    for k in range(4):
        cx = d.blob_xy[:, k, 0:1] + d.blob_v[:, k, 0:1] * t[None]   # (B, S)
        cy = d.blob_xy[:, k, 1:2] + d.blob_v[:, k, 1:2] * t[None]
        d2 = (xs[None, None] - cx[..., None, None]) ** 2 + (
            ys[None, None] - cy[..., None, None]) ** 2               # (B, S, H, W)
        img = img + torch.exp(d2 / -0.01)[..., None] * d.blob_col[:, k, None, None, None, :]
    img = img / torch.amax(img, dim=(2, 3, 4), keepdim=True)
    clips = torch.clamp(img, 0.0, 1.0)

    if texture > 0.0:
        margin = texture_margin(num_frames, texture_vel)
        gh, gw = d.grid.shape[1:3]
        # jax.image.resize's bilinear upsample: half-pixel centres, edge taps
        # renormalized, which is align_corners=False with a clamped index
        tex = F.interpolate(d.grid.permute(0, 3, 1, 2),
                            size=(gh * TEXTURE_CELL, gw * TEXTURE_CELL),
                            mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        # rigid integer drift: frame s shows the texture shifted by
        # round(v * s) pixels (half to even, as jnp.round), exactly copyable
        dy = torch.clamp(torch.round(d.vel[:, 0:1] * t[None]), -margin, margin).long()
        dx = torch.clamp(torch.round(d.vel[:, 1:2] * t[None]), -margin, margin).long()
        rows = margin + dy[..., None] + torch.arange(height, device=dev)  # (B, S, H)
        cols = margin + dx[..., None] + torch.arange(width, device=dev)   # (B, S, W)
        bi = torch.arange(b, device=dev)[:, None, None, None]
        tex_frames = tex[bi, rows[..., None], cols[:, :, None, :]]       # (B, S, H, W, 3)
        clips = torch.clamp(clips * (1.0 - texture) + tex_frames * texture, 0.0, 1.0)
    return clips


def synthetic_clips(generator: torch.Generator, batch: int, height: int, width: int,
                    num_frames: int = teacher.NUM_FRAMES, texture: float = 0.0,
                    texture_vel: float = 1.5) -> torch.Tensor:
    """(B, S, H, W, 3) float32 clips on the generator's device."""
    d = draw_clips(generator, batch, height, width, num_frames, texture, texture_vel)
    return synthetic_clips_from_draws(d, height, width, num_frames, texture, texture_vel)


def draw_explicit_jitter(generator: torch.Generator, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """(jitter_x, jitter_y) int64 of `shape` (B, S, 4): the explicit boxes'
    centre offsets, uniform over the reference's asymmetric ranges."""
    dev = generator.device
    jx = torch.randint(corruption.EXPLICIT_JITTER_X_LO, corruption.EXPLICIT_JITTER_X_HI + 1,
                       tuple(shape), generator=generator, device=dev)
    jy = torch.randint(corruption.EXPLICIT_JITTER_Y_LO, corruption.EXPLICIT_JITTER_Y_HI + 1,
                       tuple(shape), generator=generator, device=dev)
    return jx, jy


def _explicit_masks(frame_masks: torch.Tensor, height: int, width: int,
                    jitter: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    overlap_free: bool = False) -> torch.Tensor:
    """Box masks of the explicit scheme, (B, S, H, W, 1) float32, 1 = intact.

    frame_masks: (B, S, 4) int mask locations. Geometry of
    corruption.corrupt_mask_explicit with the given jitter (B, S, 4) each.
    `overlap_free=True` masks the full raster CELL of each location instead
    (no jitter): teacher pairs then expose 100% of a target's holes."""
    fm = frame_masks.long()
    section_height = height // 3
    slice_width = width // 8
    section_idx = fm // 8
    slice_idx = fm % 8
    if overlap_free:
        x0 = slice_idx * slice_width
        x1 = x0 + slice_width
        y0 = section_idx * section_height
        y1 = y0 + section_height
    else:
        jx, jy = jitter
        cx = slice_idx * slice_width + slice_width // 2 + jx.to(fm.device)
        cy = section_idx * section_height + section_height // 2 + jy.to(fm.device)
        x0 = torch.clamp(cx - corruption.EXPLICIT_BOX_W // 2, min=0)
        x1 = torch.clamp(x0 + corruption.EXPLICIT_BOX_W, max=width)
        y0 = torch.clamp(cy - corruption.EXPLICIT_BOX_H // 2, min=0)
        y1 = torch.clamp(y0 + corruption.EXPLICIT_BOX_H, max=height)
    ys = torch.arange(height, device=fm.device)[:, None]   # (H, 1)
    xs = torch.arange(width, device=fm.device)[None, :]    # (1, W)
    in_box = ((ys >= y0[..., None, None]) & (ys < y1[..., None, None])
              & (xs >= x0[..., None, None]) & (xs < x1[..., None, None]))  # (B,S,K,H,W)
    return (~torch.any(in_box, dim=2)).float()[..., None]


def explicit_batch_device(generator: torch.Generator, frame_masks: torch.Tensor,
                          height: int, width: int, texture: float = 0.0,
                          texture_vel: float = 1.5, overlap_free: bool = False):
    """(corrupted, original, masks), each (B, S, H, W, 3) float32 on the
    generator's device, for the host's teacher mask locations (B, S, 4)."""
    b, s = frame_masks.shape[:2]
    clips = synthetic_clips(generator, b, height, width, s, texture, texture_vel)
    jitter = None if overlap_free else draw_explicit_jitter(generator, frame_masks.shape)
    masks = _explicit_masks(frame_masks.to(clips.device), height, width, jitter, overlap_free)
    return clips * masks, clips, masks.expand(clips.shape)


def raster_batch_device(generator: torch.Generator, batch: int, height: int, width: int,
                        num_frames: int = teacher.NUM_FRAMES, texture: float = 0.0,
                        texture_vel: float = 1.5):
    """(corrupted, original, masks) under the STANDARD corruption scheme:
    the deterministic raster box tracking the frame index (frame s carries
    original index 2*s, the reference's every-2nd-frame subsampling,
    video_ds.py:106), the same for every clip. Adjacent frames' boxes
    overlap, so sequential contexts expose only part of a target's hole
    while far frames expose all of it: the scheme of RL and evaluation."""
    clips = synthetic_clips(generator, batch, height, width, num_frames, texture,
                            texture_vel)
    masks = corruption.raster_box_masks(
        2 * torch.arange(num_frames, device=clips.device), height, width)
    return clips * masks, clips, masks[None].expand(clips.shape)


def raster_positive_pairs(num_frames: int, height: int, width: int,
                          per_frame: int = 8, seed: int = 0) -> np.ndarray:
    """(S, P, 2) int32 context pairs that JOINTLY expose the target's whole
    raster box (exposure-1.0 pairs of the standard scheme, the analog of the
    explicit teacher's positive tables). A pixel of target box T is exposed
    by pair (i, j) iff it is intact in i or j, so the pair fully exposes T
    iff T ∩ box_i ∩ box_j = ∅."""
    boxes = [corruption.raster_box(s, height, width) for s in range(num_frames)]

    def inter(a, b):
        return (max(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), min(a[3], b[3]))

    def empty(a):
        return a[0] >= a[1] or a[2] >= a[3]

    rng = np.random.default_rng(seed)
    out = np.empty((num_frames, per_frame, 2), np.int32)
    for t in range(num_frames):
        cand = [j for j in range(num_frames) if j != t]
        pairs = [(a, b) for ai, a in enumerate(cand) for b in cand[ai + 1:]
                 if empty(inter(inter(boxes[t], boxes[a]), boxes[b]))]
        if not pairs:
            raise ValueError(
                f"no fully-exposing pair for target {t} at "
                f"{height}x{width} — frame too small for the 150x100 box grid"
            )
        picks = rng.choice(len(pairs), per_frame, replace=len(pairs) < per_frame)
        out[t] = np.asarray([pairs[p] for p in picks], np.int32)
    return out


def raster_negative_pairs(num_frames: int, height: int, width: int,
                          per_frame: int = 3, seed: int = 0) -> np.ndarray:
    """(S, P, 2) int32 context pairs with the LOWEST joint exposure of the
    target's raster box (the analog of the explicit teacher's same-group
    negatives, video_ds_explicit.py:165-191)."""
    masks = corruption.raster_box_masks(
        2 * torch.arange(num_frames), height, width)[..., 0].numpy()
    hole = 1.0 - masks
    rng = np.random.default_rng(seed)
    out = np.empty((num_frames, per_frame, 2), np.int32)
    for t in range(num_frames):
        cand = [j for j in range(num_frames) if j != t]
        scored = sorted(
            ((float((hole[t] * (1 - (1 - masks[a]) * (1 - masks[b]))).sum()), a, b)
             for ai, a in enumerate(cand) for b in cand[ai + 1:]),
        )
        worst = scored[: max(per_frame * 3, per_frame)]
        picks = rng.choice(len(worst), per_frame, replace=False)
        out[t] = np.asarray([(worst[p][1], worst[p][2]) for p in picks], np.int32)
    return out


def batch_generator(device: torch.device, seed: int, i: int) -> torch.Generator:
    """The device generator of batch i of the stream of `seed` (the port's
    `fold_in(PRNGKey(seed), i)`)."""
    state = np.random.SeedSequence([seed, i]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 31 | int(state[1]) >> 1)


class DeviceSyntheticRaster:
    """Device source under the standard raster-box corruption:
    next(i) -> (corrupted, original, masks, None, None), 20 frames."""

    def __init__(self, batch: int, height: int = 256, width: int = 256, seed: int = 0,
                 texture: float = 0.0, texture_vel: float = 1.5, device=None):
        self.batch, self.height, self.width = batch, height, width
        self.seed, self.texture, self.texture_vel = seed, texture, texture_vel
        self.device = resolve(device)

    def next(self, i: int):
        gen = batch_generator(self.device, self.seed, i)
        corrupted, original, masks = raster_batch_device(
            gen, self.batch, self.height, self.width, teacher.NUM_FRAMES,
            self.texture, self.texture_vel)
        return corrupted, original, masks, None, None


class DeviceSyntheticExplicit:
    """Device source with the explicit dataset's contract: next(i) ->
    (corrupted, original, masks, positives (B,20,16,2), negatives
    (B,20,3,2)); the teacher assignment is drawn on the host from
    np.random.default_rng((seed, i)), as the JAX source draws it, and the
    pixels on the device."""

    def __init__(self, batch: int, height: int = 256, width: int = 256, seed: int = 0,
                 texture: float = 0.0, texture_vel: float = 1.5,
                 overlap_free: bool = False, device=None):
        self.batch, self.height, self.width = batch, height, width
        self.seed, self.texture, self.texture_vel = seed, texture, texture_vel
        self.overlap_free = overlap_free
        self.device = resolve(device)

    def next(self, i: int):
        rng = np.random.default_rng((self.seed, i))
        assigns = [teacher.sample_assignment(rng) for _ in range(self.batch)]
        frame_masks = torch.from_numpy(np.stack([a.frame_masks for a in assigns]))
        gen = batch_generator(self.device, self.seed, i)
        corrupted, original, masks = explicit_batch_device(
            gen, frame_masks.to(self.device), self.height, self.width, self.texture,
            self.texture_vel, self.overlap_free)
        positives = np.stack([a.positives for a in assigns])
        negatives = np.stack([a.negatives for a in assigns])
        return corrupted, original, masks, positives, negatives


def make_source(cfg, batch: int, seed: int, texture: float, texture_vel: float,
                device=None):
    """The synthetic device source of cfg.data.synthetic_scheme: "explicit"
    teacher masks or the standard "raster" boxes; both give 20-frame clips
    (teacher.NUM_FRAMES) on `device` (CUDA unless device="cpu")."""
    h, w = cfg.data.frame_size
    if cfg.data.synthetic_scheme == "raster":
        return DeviceSyntheticRaster(batch, h, w, seed=seed, texture=texture,
                                     texture_vel=texture_vel, device=device)
    return DeviceSyntheticExplicit(batch, h, w, seed=seed, texture=texture,
                                   texture_vel=texture_vel,
                                   overlap_free=cfg.data.synthetic_overlap_free,
                                   device=device)


def check_source_frames(vid_length: int) -> None:
    """The device sources make teacher.NUM_FRAMES-frame clips; a driver that
    cuts them to vid_length frames needs no more than that."""
    if vid_length > teacher.NUM_FRAMES:
        raise ValueError(
            f"the synthetic device source makes {teacher.NUM_FRAMES}-frame clips "
            f"(teacher.NUM_FRAMES); cfg.rl.vid_length={vid_length} requires at least "
            "that many: pass a dataset or a source of longer clips")
