"""Clip datasets of the port (rovr_tpu/data/dataset.py).

Only `SyntheticExplicitDataset` is ported: the teacher-labelled synthetic
clips `imitation.run` falls back to. The frame-folder readers
(`VideoFolderDataset`, `ExplicitVideoDataset`), `DevicePrefetcher` and the
native decoder are not in the port yet (ROADMAP.md Queue 1 item 6).

Items are NHWC float32 in [0, 1]: (corrupted, original, masks, positives,
negatives), as the explicit dataset gives them (video_ds_explicit.py:112).
"""

from __future__ import annotations

from rovr_torch.config import DataConfig
from rovr_torch.data import synthetic


class SyntheticExplicitDataset:
    """Drop-in ExplicitVideoDataset over synthetic clips (no disk needed):
    item i is `synthetic_explicit_batch` of a seed made from (seed, i), as
    the JAX package makes it, so both packages give the same items."""

    def __init__(self, cfg: DataConfig, seed: int = 0, length: int = 64):
        self.cfg = cfg
        self.seed = seed
        self.length = 10 if cfg.debug_short_dataset else length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int):
        h, w = self.cfg.frame_size
        return synthetic.synthetic_explicit_batch(
            (self.seed * 1_000_003 + idx) & 0x7FFFFFFF, h, w
        )
