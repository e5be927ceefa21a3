"""Structured metrics logging: JSONL always, TensorBoard when it imports
(rovr_tpu/utils/logging.py, PyTorch port).

Records are one JSON object per line in <log_dir>/metrics.jsonl with the
JAX package's keys: {"t", "tag", "value", "step"} for a scalar and
{"t", "tag", "text", "step"} for text.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np


class MetricsWriter:
    """JSONL scalar/text writer, mirrored to TensorBoard when
    `torch.utils.tensorboard` imports."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard.writer import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir, flush_secs=10)
            except ImportError:
                self._tb = None

    def scalar(self, tag: str, value: Any, step: int) -> None:
        v = float(value)
        self._f.write(json.dumps({"t": time.time(), "tag": tag, "value": v,
                                  "step": step}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, v, step)

    def scalars(self, values: Dict[str, Any], step: int) -> None:
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def image(self, tag: str, image, step: int) -> None:
        """image: (H, W, 3) float in [0, 1]. To TensorBoard when it is there,
        else a PNG <log_dir>/images/<tag>_<step>.png."""
        img = np.asarray(image)
        if self._tb is not None:
            self._tb.add_image(tag, img.transpose(2, 0, 1), step)
            return
        from rovr_torch.utils.png import write_png

        img_dir = os.path.join(self.log_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        u8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        write_png(os.path.join(img_dir, f"{tag.replace('/', '_')}_{step:08d}.png"), u8)

    def text(self, tag: str, text: str, step: int) -> None:
        self._f.write(json.dumps({"t": time.time(), "tag": tag, "text": text,
                                  "step": step}) + "\n")
        if self._tb is not None:
            self._tb.add_text(tag, text, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
