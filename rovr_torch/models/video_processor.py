"""VideoProcessor: per-frame features + the composite "state canvas"
(rovr_tpu/models/video_processor.py).

A frozen backbone (ResNet-50, or the tiny trunk in tests) encodes each frame;
a linear head projects to the per-frame feature, a second one to a square
tile laid out row-major, `tiles_per_row` tiles per row, on a single-channel
canvas. `insert_encoded_frame_batch` re-encodes reconstructed frames and
overwrites their tiles; on a CUDA device with grad off and the module frozen
it replays that work from a captured CUDA graph (`_ReencodeGraph`).

Public layout follows the JAX package: frames NHWC, canvas (B, C, C, 1).
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

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


_GRAPHS_MAX = 4   # captured re-encodes a module keeps; the oldest goes first


class _ReencodeGraph:
    """`VideoProcessor._insert_eager` captured in a CUDA graph on static
    copies of its inputs (same shapes, strides and dtypes). Replaying reads
    the module's tensors at the addresses they had when it was captured,
    so the caller keys it on them."""

    def __init__(self, vp: "VideoProcessor", indices, frames, canvas):
        self.inputs = tuple(t.clone() for t in (indices, frames, canvas))
        dev = frames.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):   # warm-up off the capture, as capture requires
            vp._insert_eager(*self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls (a loader's copies) may go on
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = vp._insert_eager(*self.inputs)

    def __call__(self, indices, frames, canvas) -> Tuple[torch.Tensor, torch.Tensor]:
        for static, t in zip(self.inputs, (indices, frames, canvas)):
            static.copy_(t)
        self.graph.replay()
        # clones: the caller keeps every step's canvas, the next replay overwrites these
        return tuple(t.clone() for t in self.outputs)


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
        self._graphs: "collections.OrderedDict[tuple, _ReencodeGraph]" = \
            collections.OrderedDict()
        self._parts = tuple(self.modules())   # walked once: `_graph_key` runs every step

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
        `indices` (B,) of canvas (B, C, C, 1). Returns (new canvas, feats).

        On a CUDA device with grad off and every parameter frozen (the
        rollout) the work is replayed from a CUDA graph captured on the
        first call of its key (`_graph_key`); otherwise it runs eagerly.
        Both run the same ops. Each call adds one to one counter on this
        function: `captures` (a capture, then its first replay), `replays`
        or `eager`."""
        counts = VideoProcessor.insert_encoded_frame_batch
        key = self._graph_key(indices, frames, canvas)
        if key is None:
            counts.eager += 1
            return self._insert_eager(indices, frames, canvas)
        with torch.cuda.device(frames.device):   # a graph replays on its own device
            graph = self._graphs.get(key)
            if graph is None:
                if len(self._graphs) >= _GRAPHS_MAX:
                    torch.cuda.synchronize()   # no replay still reads what goes
                    self._graphs.popitem(last=False)
                graph = self._graphs[key] = _ReencodeGraph(self, indices, frames, canvas)
                counts.captures += 1
            else:
                counts.replays += 1
            return graph(indices, frames, canvas)

    def _graph_key(self, indices, frames, canvas) -> Optional[tuple]:
        """None where the call runs eagerly: off CUDA, with grad enabled, or
        with a parameter that requires grad. Else what a captured graph
        depends on: the inputs' shapes, strides and dtypes, the device,
        inference mode (its static buffers cannot be written outside it),
        the TF32 flags that pick the kernels of f32 products,
        and the address of every parameter and buffer of the module, so a
        graph never replays against other weights than the bound ones."""
        if frames.device.type != "cuda" or torch.is_grad_enabled():
            return None
        params = [p for m in self._parts for p in m._parameters.values() if p is not None]
        if any(p.requires_grad for p in params):
            return None
        ptrs = [p.data_ptr() for p in params] + [
            b.data_ptr() for m in self._parts for b in m._buffers.values() if b is not None]
        return (tuple((t.shape, t.stride(), t.dtype) for t in (indices, frames, canvas)),
                frames.device, torch.is_inference_mode_enabled(),
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                tuple(ptrs))

    def _insert_eager(
        self, indices: torch.Tensor, frames: torch.Tensor, canvas: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
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


VideoProcessor.insert_encoded_frame_batch.captures = 0
VideoProcessor.insert_encoded_frame_batch.replays = 0
VideoProcessor.insert_encoded_frame_batch.eager = 0
