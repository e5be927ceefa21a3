"""Clip datasets of the port and their prefetcher (rovr_tpu/data/dataset.py).

Folder datasets read a RealVSR-style tree, <root>/<clip>/<frame>.png with
50 frames a clip, each frame two videos side by side (video_ds.py:9-135,
video_ds_explicit.py:9-112). Frames are decoded by the port's own decoder
(`data/native_loader`, no OpenCV) with cfg.use_native_loader, else by cv2.
Items are NHWC float32 in [0, 1] (uint8 with cfg.stage_uint8 for
`VideoFolderDataset`): (corrupted, original, masks), and for the explicit
datasets also the teacher's (positives, negatives).

`DevicePrefetcher` decodes on worker threads and stages items on the
device ahead of the consumer: each item is pinned and copied on a CUDA
stream of its own, and the consumer's stream waits on that copy.
"""

from __future__ import annotations

import heapq
import os
import queue
import threading
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rovr_torch.config import DataConfig
from rovr_torch.data import corruption, synthetic, teacher
from rovr_torch.parallel.mesh import Mesh, local_rows


def list_clips(root_folder: str) -> List[str]:
    """Sorted clip subfolders (video_ds.py:13)."""
    return sorted(d for d in os.listdir(root_folder)
                  if os.path.isdir(os.path.join(root_folder, d)))


def _decode_frame(path: str, out_hw: Tuple[int, int], half: int,
                  use_native: bool = True) -> np.ndarray:
    """Decode one frame, resize to 1024x512, split, resize the half to
    out_hw (video_ds.py:107-113): the port's decoder, or cv2 with
    `use_native=False` (cfg.data.use_native_loader)."""
    if use_native:
        from rovr_torch.data import native_loader

        return native_loader.decode_half(path, out_hw, half)
    import cv2

    frame = cv2.imread(path)
    if frame is None:
        raise IOError(f"cv2 could not read {path}")
    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    frame = cv2.resize(frame, (1024, 512))
    halves = np.split(frame, 2, axis=1)
    return cv2.resize(halves[half], (out_hw[1], out_hw[0]))


class _FolderDataset:
    """A tree of clip folders, two videos per folder (left and right half)."""

    def __init__(self, cfg: DataConfig, seed: int = 0):
        self.cfg = cfg
        self.root = cfg.root_folder
        self.clips = list_clips(self.root)
        self.seed = seed

    def __len__(self) -> int:
        n = len(self.clips) * 2
        return min(n, 10) if self.cfg.debug_short_dataset else n

    def _frames(self, idx: int):
        """(frame names of item idx's folder, its half, its generator)."""
        folder = os.path.join(self.root, self.clips[idx // 2])
        names = sorted(os.listdir(folder))
        return folder, names, idx % 2, np.random.default_rng((self.seed, idx))

    def _decode(self, folder: str, name: str, half: int) -> np.ndarray:
        return _decode_frame(os.path.join(folder, name), self.cfg.frame_size, half,
                             use_native=self.cfg.use_native_loader)


class VideoFolderDataset(_FolderDataset):
    """Random-mask corruption dataset (VideoDataset2, video_ds.py:9-135):
    every 2nd of a folder's 50 frames, 25 a video; item idx is half idx % 2
    of folder idx // 2, corrupted by a generator made from (seed, idx)."""

    def __getitem__(self, idx: int):
        cfg = self.cfg
        folder, names, half, rng = self._frames(idx)
        frames, corrupted, masks = [], [], []
        for i in range(0, cfg.frames_per_clip, 2):
            frame = self._decode(folder, names[i], half)
            c, m = corruption.corrupt_frame(
                frame, i, rng, difficulty=cfg.difficulty, brightness=cfg.brightness,
                noise=cfg.noise, apply_jitter_box=cfg.apply_jitter_box)
            frames.append(frame)
            corrupted.append(c)
            masks.append(m)
        if cfg.stage_uint8:   # uint8 to the device; the train step divides by 255
            return (np.asarray(corrupted, dtype=np.uint8), np.asarray(frames, dtype=np.uint8),
                    np.asarray(masks, dtype=np.float32))
        f = np.float32(1.0 / 255.0)
        return (np.asarray(corrupted, dtype=np.float32) * f,
                np.asarray(frames, dtype=np.float32) * f,
                np.asarray(masks, dtype=np.float32))


class ExplicitVideoDataset(_FolderDataset):
    """Teacher-labelled dataset (VideoDatasetExplicit,
    video_ds_explicit.py:9-112): 20 frames in the teacher's shuffled order,
    its structured masks, and the (20,16,2)/(20,3,2) positive/negative
    context pairs."""

    def __getitem__(self, idx: int):
        folder, names, half, rng = self._frames(idx)
        assign = teacher.sample_assignment(rng)
        frames, corrupted, masks = [], [], []
        for i in range(teacher.NUM_FRAMES):
            frame = self._decode(folder, names[assign.frame_order[i]], half)
            c, m = corruption.corrupt_frame_explicit(frame, assign.frame_masks[i], rng)
            frames.append(frame)
            corrupted.append(c)
            masks.append(m)
        f = np.float32(1.0 / 255.0)
        return (np.asarray(corrupted, dtype=np.float32) * f,
                np.asarray(frames, dtype=np.float32) * f,
                np.asarray(masks, dtype=np.float32), assign.positives, assign.negatives)


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


class _WorkerError:
    """Envelope carrying a worker thread's exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class DevicePrefetcher:
    """Worker threads decode `dataset[indices[k]]`; a stager thread puts the
    items in index order and, with `to_device`, stages them on `device`
    (default: the GPU) ahead of the consumer, at most `depth` staged.

    On CUDA the stager pins each array of an item and copies it with
    `non_blocking=True` on a stream of its own, then records an event; the
    consumer's stream waits on that event before it uses the item, and each
    tensor is tied to the consumer's stream (`record_stream`), so its memory
    is not reused while the consumer's kernels may still read it. The pinned
    blocks come from PyTorch's caching host allocator, which keeps a block
    until the copies that read it have finished. On the CPU (device="cpu")
    items become CPU tensors; without `to_device` they stay as the dataset
    gave them.

    `sharding` (a data `parallel.mesh.Mesh`): each rank stages only its rows
    of each array of an item (axis 0, split evenly over the ranks, as the
    JAX prefetcher's batch sharding splits it) onto the mesh's device, which
    replaces `device`; the ranks' shards concatenate to the item. The
    dataset still decodes whole items.

    A worker's exception is raised in the consumer. `close()` stops and
    joins every thread and drains both queues. `wait_s` sums the seconds the
    consumer blocked waiting for an item. Worker threads, not processes
    (the reference's 32 DataLoader workers, test.py:60): the port's decoder
    releases the GIL in zlib and in its C++ code."""

    def __init__(self, dataset, indices: Optional[Sequence[int]] = None,
                 num_workers: int = 4, depth: int = 2, sharding=None,
                 to_device: bool = True, device=None):
        from rovr_torch import device as device_mod

        if sharding is not None and not isinstance(sharding, Mesh):
            raise TypeError(f"sharding must be a parallel.mesh.Mesh, got "
                            f"{type(sharding).__name__}")
        self.dataset = dataset
        self.indices = list(indices if indices is not None else range(len(dataset)))
        self.sharding = sharding
        if sharding is not None:
            if not to_device:
                raise ValueError("sharding stages onto the mesh's device: to_device=False "
                                 "leaves nothing to shard")
            device = sharding.device
        self.device = device_mod.resolve(device) if to_device else None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device is not None and self.device.type == "cuda" else None)
        self.wait_s = 0.0
        self._host_q: "queue.Queue" = queue.Queue(maxsize=max(2, depth))
        self._device_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._workers = [
            threading.Thread(target=self._produce, args=(w, num_workers), daemon=True)
            for w in range(num_workers)
        ]
        self._stager = threading.Thread(target=self._stage, daemon=True)
        for t in self._workers:
            t.start()
        self._stager.start()

    def _put(self, q: "queue.Queue", item) -> bool:
        """put() that observes the stop flag, so a thread blocked on a full
        queue exits when the prefetcher is closed early."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, worker_id: int, num_workers: int) -> None:
        for pos in range(worker_id, len(self.indices), num_workers):
            if self._stop.is_set():
                return
            try:
                item = self.dataset[self.indices[pos]]
            except BaseException as e:  # handed to the consumer, which raises it
                self._put(self._host_q, (pos, _WorkerError(e)))
                return
            if not self._put(self._host_q, (pos, item)):
                return

    def _to_device(self, item):
        """(tensors on the device, the copy's event or None)."""
        arrays = [torch.as_tensor(np.asarray(x)) for x in item]
        if self.sharding is not None:
            arrays = [a[local_rows(self.sharding, a.shape[0])] for a in arrays]
        if self._stream is None:
            return tuple(a.to(self.device) for a in arrays), None
        with torch.cuda.stream(self._stream):
            out = tuple(a.pin_memory().to(self.device, non_blocking=True) for a in arrays)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _stage(self) -> None:
        heap: list = []
        next_pos = 0
        total = len(self.indices)
        while next_pos < total and not self._stop.is_set():
            try:
                pos, item = self._host_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if isinstance(item, _WorkerError):
                self._put(self._device_q, item)
                return
            heapq.heappush(heap, (pos, item))   # positions are unique
            while heap and heap[0][0] == next_pos:
                it = heapq.heappop(heap)[1]
                try:
                    staged = self._to_device(it) if self.device is not None else (it, None)
                except BaseException as e:
                    self._put(self._device_q, _WorkerError(e))
                    return
                if not self._put(self._device_q, staged):
                    return
                next_pos += 1
        self._put(self._device_q, None)

    def __iter__(self) -> Iterator:
        while True:
            t0 = time.perf_counter()
            got = self._device_q.get()
            self.wait_s += time.perf_counter() - t0
            if got is None:
                return
            if isinstance(got, _WorkerError):
                raise got.exc
            item, event = got
            if event is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(event)
                for t in item:
                    t.record_stream(consumer)
            yield item

    def close(self, timeout: float = 5.0) -> None:
        """Stop and reclaim the pipeline: signal stop, join every worker and
        the stager (their queue operations poll the stop flag), and drop the
        items still queued."""
        self._stop.set()
        for t in self._workers:
            t.join(timeout)
        self._stager.join(timeout)
        for q in (self._host_q, self._device_q):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
