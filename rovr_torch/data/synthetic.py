"""Synthetic clip generator with the same tensor contract as the folder
datasets, for tests, `infer.run` and the chip smoke run when no frame
tree is on disk.

The port's numpy-only copy of `rovr_tpu/data/synthetic.py`'s
`synthetic_clip`, `synthetic_batch` and `synthetic_explicit_batch`: the same
draws from the same `np.random.Generator`, so both packages make identical
clips from one seed.
Frames are smooth moving gradients plus drifting blobs, so inpainting is
meaningful (not pure noise).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from rovr_torch.data import corruption, teacher


def synthetic_clip(
    rng: np.random.Generator,
    num_frames: int = 20,
    height: int = 256,
    width: int = 256,
) -> np.ndarray:
    """uint8 (S, H, W, 3) clip: moving gradients + drifting gaussian blobs."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    ys, xs = ys / height, xs / width
    phase = rng.uniform(0, 2 * np.pi, size=3)
    speed = rng.uniform(0.5, 2.0, size=3)
    blob_xy = rng.uniform(0.2, 0.8, size=(4, 2)).astype(np.float32)
    blob_v = rng.uniform(-0.02, 0.02, size=(4, 2)).astype(np.float32)
    blob_col = rng.uniform(0.3, 1.0, size=(4, 3)).astype(np.float32)

    t = np.arange(num_frames, dtype=np.float32)[:, None, None, None]  # (T,1,1,1)
    sp = speed.astype(np.float32)[None, None, None, :]                # (1,1,1,3)
    ph = phase.astype(np.float32)[None, None, None, :]
    xs4 = xs[None, :, :, None]
    ys4 = ys[None, :, :, None]
    img = 0.5 + 0.4 * np.sin(2 * np.pi * (xs4 + 0.01 * sp * t) + ph) * np.cos(
        2 * np.pi * (ys4 - 0.013 * sp * t)
    )  # (T, H, W, 3)
    for b in range(4):
        cx = blob_xy[b, 0] + blob_v[b, 0] * t[..., 0]  # (T,1,1)
        cy = blob_xy[b, 1] + blob_v[b, 1] * t[..., 0]
        d2 = (xs[None] - cx) ** 2 + (ys[None] - cy) ** 2  # (T, H, W)
        img += np.exp(d2 / -0.01)[..., None] * blob_col[b]
    img /= img.max(axis=(1, 2, 3), keepdims=True)
    np.clip(img, 0.0, 1.0, out=img)
    return (img * 255).astype(np.uint8)


def synthetic_batch(
    seed: int,
    num_frames: int = 20,
    height: int = 256,
    width: int = 256,
    difficulty: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(corrupted, original, masks) float32 (S, H, W, 3) in [0, 1].

    Same contract as the random-mask dataset (video_ds.py:135), NHWC.
    """
    rng = np.random.default_rng(seed)
    clip = synthetic_clip(rng, num_frames, height, width)
    corrupted = np.empty_like(clip)
    masks = np.empty_like(clip)
    for s in range(num_frames):
        # corruption is indexed by the pre-subsample frame id (2*s)
        corrupted[s], masks[s] = corruption.corrupt_frame(
            clip[s], 2 * s, rng, difficulty=difficulty
        )
    f = np.float32(1.0 / 255.0)
    return corrupted * f, clip * f, masks.astype(np.float32)


def synthetic_explicit_batch(
    seed: int,
    height: int = 256,
    width: int = 256,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(corrupted, original, masks, positives, negatives) — teacher-labeled.

    Same contract as the explicit dataset (video_ds_explicit.py:112), NHWC:
    20 frames with structured masks, (20,16,2) positive and (20,3,2) negative
    context pairs.
    """
    rng = np.random.default_rng(seed)
    assign = teacher.sample_assignment(rng)
    clip = synthetic_clip(rng, teacher.NUM_FRAMES, height, width)
    # the explicit dataset shuffles frame order by the permutation
    # (video_ds_explicit.py:90)
    clip = clip[assign.frame_order]
    corrupted = np.empty_like(clip)
    masks = np.empty_like(clip)
    for s in range(teacher.NUM_FRAMES):
        corrupted[s], masks[s] = corruption.corrupt_frame_explicit(
            clip[s], assign.frame_masks[s], rng
        )
    f = np.float32(1.0 / 255.0)
    return (
        corrupted * f,
        clip * f,
        masks.astype(np.float32),
        assign.positives,
        assign.negatives,
    )


def synthetic_clips(
    seed: int,
    index: int,
    batch: int,
    num_frames: int = 20,
    height: int = 256,
    width: int = 256,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch `index` of the clip stream of `seed`: (corrupted, original,
    masks) float32 (B, S, H, W, 3), clip j drawn by
    `synthetic_batch(seed + index * batch + j)`."""
    clips = [synthetic_batch(seed + index * batch + j, num_frames, height, width)
             for j in range(batch)]
    return tuple(np.stack([c[k] for c in clips]) for k in range(3))
