"""Synthetic video corruption: brightness shifts, pixel noise, box masks.

The port's numpy-only copy of `rovr_tpu/data/corruption.py` (`raster_box`,
`jitter_box`, `corrupt_frame`, the explicit scheme's `corrupt_mask_explicit`
and `corrupt_frame_explicit`), same math and same generator draws, so both
packages make the same clips from the same seed; `raster_box_masks` is the
torch twin of its `raster_box_masks_jax`, for masks made on the device.

Geometry notes (vs the original ROVR data code, video_ds.py:18-89): the
original computes a jittered random box and then DISCARDS it (`mask`
re-initialized at video_ds.py:59) before applying the deterministic raster
box. The default here reproduces that (the random box has no effect); pass
`apply_jitter_box=True` for the evidently intended extra box.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# Deterministic raster box geometry (video_ds.py:62-87).
RASTER_BOX_H = 100
RASTER_BOX_W = 150
FRAMES_PER_SECTION = 8

# Explicit-dataset jittered box geometry (video_ds_explicit.py:36-60).
EXPLICIT_BOX_H = 50   # 100 // 2
EXPLICIT_BOX_W = 100  # 200 // 2
# randint(-25 // 2, 25 // 2) = randint(-13, 12): Python floor division makes
# the jitter range ASYMMETRIC (video_ds_explicit.py:48-49, video_ds.py:46-47).
EXPLICIT_JITTER_X_LO, EXPLICIT_JITTER_X_HI = -13, 12
EXPLICIT_JITTER_Y_LO, EXPLICIT_JITTER_Y_HI = -63, 62


def raster_box(frame_index: int, h: int, w: int) -> Tuple[int, int, int, int]:
    """Deterministic box whose position tracks frame_index (video_ds.py:62-87).

    Returns (start_y, end_y, start_x, end_x), clipped to the frame.
    """
    section_idx = frame_index // FRAMES_PER_SECTION
    position_idx = frame_index % FRAMES_PER_SECTION
    start_y = section_idx * h // 3
    end_y = start_y + RASTER_BOX_H
    start_x = position_idx * w // 8
    end_x = start_x + RASTER_BOX_W
    return (max(0, start_y), min(h, end_y), max(0, start_x), min(w, end_x))


def jitter_box(
    frame_index: int, h: int, w: int, rng: np.random.Generator
) -> Tuple[int, int, int, int]:
    """Jittered raster-positioned box (video_ds.py:34-55 geometry)."""
    section_height = h // 3
    slice_width = w // 8
    section_idx = frame_index // 8
    slice_idx = frame_index % 8
    cx = slice_idx * slice_width + slice_width // 2
    cy = section_idx * section_height + section_height // 2
    cx += int(rng.integers(EXPLICIT_JITTER_X_LO, EXPLICIT_JITTER_X_HI + 1))
    cy += int(rng.integers(EXPLICIT_JITTER_Y_LO, EXPLICIT_JITTER_Y_HI + 1))
    start_x = max(0, cx - (225 // 2) // 2)
    end_x = min(w, start_x + 225 // 2)
    start_y = max(0, cy - (125 // 2) // 2)
    end_y = min(h, start_y + 125 // 2)
    return (start_y, end_y, start_x, end_x)


def corrupt_frame(
    frame: np.ndarray,
    frame_index: int,
    rng: np.random.Generator,
    difficulty: int = 2,
    brightness: int = 40,
    noise: int = 20,
    apply_jitter_box: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Corrupt one uint8 HWC frame (video_ds.py:18-89).

    With difficulty>=2, prob 1/5 each the frame gets a global +brightness or
    uniform +-noise corruption and NO mask (early return, mask all ones).
    Otherwise a deterministic raster box is zeroed. Returns (corrupted, mask)
    with mask 1 where pixels are intact.
    """
    frame_index = frame_index // 2  # video_ds.py:19
    h, w, _ = frame.shape
    mask = np.ones_like(frame)

    if difficulty >= 2:
        n = int(rng.integers(0, 5))
        if n < 1:
            # `frame + brightness` runs in the frame's own dtype, so uint8
            # pixels WRAP (230+40 -> 14) and the clip is a no-op — the
            # original data code's behaviour (video_ds.py:26), kept.
            return np.clip(
                frame + np.asarray(brightness, frame.dtype), 0, 255
            ).astype(frame.dtype), mask
        if n < 2:
            noise_matrix = rng.integers(
                -noise, noise, frame.shape, dtype=np.int32
            )
            return np.clip(frame.astype(np.int32) + noise_matrix, 0, 255).astype(
                frame.dtype
            ), mask

    if difficulty > 0 and apply_jitter_box:
        extra_index = int(rng.integers(0, 101)) // 2
        y0, y1, x0, x1 = jitter_box(extra_index, h, w, rng)
        mask[y0:y1, x0:x1, :] = 0

    y0, y1, x0, x1 = raster_box(frame_index, h, w)
    mask[y0:y1, x0:x1, :] = 0

    return frame * mask, mask


def corrupt_mask_explicit(
    h: int, w: int, location: int, rng: np.random.Generator, mask: np.ndarray
) -> np.ndarray:
    """Zero one jittered box at raster `location` into `mask`.

    Parity: video_ds_explicit.py:36-60.
    """
    section_height = h // 3
    slice_width = w // 8
    section_idx = location // 8
    slice_idx = location % 8
    cx = slice_idx * slice_width + slice_width // 2
    cy = section_idx * section_height + section_height // 2
    cx += int(rng.integers(EXPLICIT_JITTER_X_LO, EXPLICIT_JITTER_X_HI + 1))
    cy += int(rng.integers(EXPLICIT_JITTER_Y_LO, EXPLICIT_JITTER_Y_HI + 1))
    start_x = max(0, cx - EXPLICIT_BOX_W // 2)
    end_x = min(w, start_x + EXPLICIT_BOX_W)
    start_y = max(0, cy - EXPLICIT_BOX_H // 2)
    end_y = min(h, start_y + EXPLICIT_BOX_H)
    mask[start_y:end_y, start_x:end_x, :] = 0
    return mask


def corrupt_frame_explicit(
    frame: np.ndarray, locations: Sequence[int], rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply one jittered box per mask location (video_ds_explicit.py:62-71)."""
    h, w, _ = frame.shape
    mask = np.ones_like(frame)
    for location in locations:
        mask = corrupt_mask_explicit(h, w, int(location), rng, mask)
    return frame * mask, mask


def raster_box_masks(frame_indices: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Masks of the deterministic raster boxes, on frame_indices' device.

    frame_indices: int tensor (S,) of ORIGINAL (pre-//2) frame indices, as fed
    to corrupt_frame. Returns float32 mask (S, H, W, 1), 1 = intact: the
    boxes of `raster_box` as broadcast comparisons, no gathers."""
    idx = frame_indices.long() // 2
    section_idx = idx // FRAMES_PER_SECTION
    position_idx = idx % FRAMES_PER_SECTION
    start_y = section_idx * h // 3
    end_y = torch.clamp(start_y + RASTER_BOX_H, max=h)
    start_x = position_idx * w // 8
    end_x = torch.clamp(start_x + RASTER_BOX_W, max=w)
    ys = torch.arange(h, device=idx.device)[None, :, None]
    xs = torch.arange(w, device=idx.device)[None, None, :]
    in_box = ((ys >= start_y[:, None, None]) & (ys < end_y[:, None, None])
              & (xs >= start_x[:, None, None]) & (xs < end_x[:, None, None]))
    return (~in_box).float()[..., None]
