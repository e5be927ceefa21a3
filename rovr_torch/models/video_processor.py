"""VideoProcessor: per-frame features + the composite "state canvas"
(rovr_tpu/models/video_processor.py).

A frozen backbone (ResNet-50, or the tiny trunk in tests) encodes each frame;
a linear head projects to the per-frame feature, a second one to a square
tile laid out row-major, `tiles_per_row` tiles per row, on a single-channel
canvas. `insert_encoded_frame_batch` re-encodes reconstructed frames and
overwrites their tiles.

Public layout follows the JAX package: frames NHWC, canvas (B, C, C, 1).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rovr_torch.models.resnet import ResNet50, TinyBackbone


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(x, (N, *size, C), "bilinear")` for NHWC x.

    JAX's bilinear resize widens its triangle kernel when it shrinks
    (antialiasing) and is plain bilinear when it grows; torch matches it
    with antialias=True when shrinking and antialias=False when growing."""
    h, w = x.shape[1:3]
    shrink = size[0] < h or size[1] < w
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
        align_corners=False, antialias=shrink,
    )
    return y.permute(0, 2, 3, 1)


class VideoProcessor(nn.Module):
    def __init__(self, canvas_size: int = 160, tile: int = 32,
                 tiles_per_row: int = 5, feature_dim: int = 1024,
                 dtype: torch.dtype = torch.bfloat16,
                 backbone_name: str = "resnet50", spatial_pool: int = 1):
        super().__init__()
        self.canvas_size = canvas_size
        self.tile = tile
        self.tiles_per_row = tiles_per_row
        self.feature_dim = feature_dim
        self.spatial_pool = spatial_pool
        self.backbone = (
            TinyBackbone(dtype=dtype, spatial_pool=spatial_pool)
            if backbone_name == "tiny"
            else ResNet50(dtype=dtype, spatial_pool=spatial_pool)
        )
        c = self.backbone.out_features
        g = spatial_pool
        if g > 1 and (feature_dim % (g * g) or tile % g):
            raise ValueError(
                "feature_dim must divide by spatial_pool^2 and tile by "
                f"spatial_pool (got {feature_dim}, {tile}, g={g})"
            )
        self.feat_head = nn.Linear(c, feature_dim // (g * g))
        self.tile_head = nn.Linear(c, (tile // g) ** 2)

    def encode(self, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """frames (N, 224, 224, 3) -> (tiles (N, tile, tile), feats (N, D)).
        The backbone is frozen; only the two heads carry gradients."""
        with torch.no_grad():
            pooled = self.backbone(frames)
        g = self.spatial_pool
        if g > 1:
            n = pooled.shape[0]
            cells = pooled.reshape(n, g * g, -1)
            feats = self.feat_head(cells).reshape(n, self.feature_dim)
            t = self.tile // g
            tiles = self.tile_head(cells).reshape(n, g, g, t, t)
            tiles = tiles.permute(0, 1, 3, 2, 4).reshape(n, self.tile, self.tile)
            return tiles, feats
        feats = self.feat_head(pooled)
        tiles = self.tile_head(pooled).reshape(-1, self.tile, self.tile)
        return tiles, feats

    def forward(self, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """frames (B, S, 224, 224, 3) -> (canvas (B,C,C,1), feats (B,S,D))."""
        b, s = frames.shape[:2]
        tiles, feats = self.encode(frames.reshape((b * s,) + frames.shape[2:]))
        tiles = tiles.reshape(b, s, self.tile, self.tile)
        feats = feats.reshape(b, s, self.feature_dim)
        rows = -(-s // self.tiles_per_row)
        pad = rows * self.tiles_per_row - s
        if pad:
            tiles = torch.cat([tiles, tiles.new_zeros(b, pad, self.tile, self.tile)], 1)
        grid = tiles.reshape(b, rows, self.tiles_per_row, self.tile, self.tile)
        grid = grid.permute(0, 1, 3, 2, 4).reshape(
            b, rows * self.tile, self.tiles_per_row * self.tile
        )
        canvas = grid.new_zeros(b, self.canvas_size, self.canvas_size)
        canvas[:, :grid.shape[1], :grid.shape[2]] = grid
        return canvas[..., None], feats

    def insert_encoded_frame_batch(
        self, indices: torch.Tensor, frames: torch.Tensor, canvas: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Re-encode frames (B, H, W, 3) (resized to 224) and overwrite tile
        `indices` (B,) of canvas (B, C, C, 1). Returns (new canvas, feats)."""
        b = frames.shape[0]
        tiles, feats = self.encode(resize_bilinear(frames, (224, 224)))
        ar = torch.arange(self.tile, device=canvas.device)
        ys = (indices // self.tiles_per_row * self.tile)[:, None] + ar  # (B, tile)
        xs = (indices % self.tiles_per_row * self.tile)[:, None] + ar
        bi = torch.arange(b, device=canvas.device)[:, None, None]
        canvas = canvas.index_put(
            (bi, ys[:, :, None], xs[:, None, :]), tiles.to(canvas.dtype)[..., None]
        )
        return canvas, feats

    def extract_patch(self, indices: torch.Tensor, canvas: torch.Tensor) -> torch.Tensor:
        """Tiles `indices` (B, K) of canvas (B, C, C, 1) -> (B, K, tile, tile),
        for the ActionLSTM's history. A tile's origin is (idx // tiles_per_row,
        idx % tiles_per_row) * tile, clamped to the canvas as
        jax.lax.dynamic_slice clamps it."""
        ar = torch.arange(self.tile, device=canvas.device)
        y0 = (indices // self.tiles_per_row * self.tile).clamp(0, canvas.shape[1] - self.tile)
        x0 = (indices % self.tiles_per_row * self.tile).clamp(0, canvas.shape[2] - self.tile)
        ys = (y0[..., None] + ar)[..., :, None]                  # (B, K, tile, 1)
        xs = (x0[..., None] + ar)[..., None, :]                  # (B, K, 1, tile)
        bi = torch.arange(canvas.shape[0], device=canvas.device)[:, None, None, None]
        return canvas[..., 0][bi, ys, xs]
