"""The port's frame-folder data path (rovr_torch/data/native_loader.py,
csrc/frame_decode.cpp, data/dataset.py's folder readers and
DevicePrefetcher, and `rl.run` over a tree) on the CPU.

The decoder: PNG unfiltering of all five filter types, for every 8-bit
color type, equals a numpy reference, and what it does not read raises
IOError naming the file. Where the JAX package's native decoder
(native/libvideoload.so, OpenCV) loads, `decode_half` equals its
`decode_half` bit for bit at 1024x512 over every filter type, and at
640x360, 1280x720 and 800x600 the share of exact values is printed (it was
1.0 at each size when this file was written; the bound held is 1 LSB).

The readers: `VideoFolderDataset` (float and `stage_uint8`) and
`ExplicitVideoDataset` give the JAX readers' items on the same tree and
seed: corrupted, original and masks within 1 LSB, the teacher's pairs
equal. The prefetcher keeps index order, raises a worker's exception in
the consumer, closes with full queues, holds under twice as many workers
as cores at a 1 us switch interval, and refuses a `sharding` that is no mesh. `rl.run`
over a tiny tree logs finite steps and the prefetcher's wait, and writes
its checkpoint.
"""

import dataclasses
import glob
import json
import os
import struct
import sys
import time
import zlib

import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from conftest import tiny_model_overrides
from rovr_tpu.config import DataConfig as JDataConfig
from rovr_tpu.data import dataset as jdataset
from rovr_tpu.data import native_loader as jnative
from rovr_torch.config import DataConfig, from_dict
from rovr_torch.data import dataset, native_loader
from rovr_torch.train import rl

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small shapes: more intra-op threads only contend with the other test
    workers of the run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def encode_png(samples, color, filters, palette=None, depth=8, interlace=0) -> bytes:
    """(H, W, C) samples -> PNG bytes, row y filtered with filters[y % len]."""
    h, w, c = samples.shape
    x = samples.reshape(h, w * c).astype(np.int16)
    up = np.vstack([np.zeros((1, w * c), np.int16), x[:-1]])
    left = np.hstack([np.zeros((h, c), np.int16), x[:, :-c]])
    ul = np.hstack([np.zeros((h, c), np.int16), up[:, :-c]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    pred = {0: np.zeros_like(x), 1: left, 2: up, 3: (left + up) // 2, 4: paeth}
    raw = b"".join(bytes([f]) + ((x[y] - pred[f][y]) % 256).astype(np.uint8).tobytes()
                   for y, f in ((y, filters[y % len(filters)]) for y in range(h)))
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                                            0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    half = len(raw) // 2   # two IDAT chunks: the stream may be split anywhere
    z = zlib.compress(raw)
    return out + _chunk(b"IDAT", z[:half]) + _chunk(b"IDAT", z[half:]) + _chunk(b"IEND", b"")


def unfilter_reference(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """PNG row unfiltering, byte by byte (the PNG specification, 9.2)."""
    out = np.zeros((h, stride), np.int64)
    for y in range(h):
        f = raw[y * (stride + 1)]
        row = raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)]
        for i in range(stride):
            a = out[y, i - bpp] if i >= bpp else 0
            b = out[y - 1, i] if y else 0
            c = out[y - 1, i - bpp] if y and i >= bpp else 0
            pr = {0: 0, 1: a, 2: b, 3: (a + b) // 2}.get(f)
            if pr is None:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[y, i] = (row[i] + pr) % 256
    return out.astype(np.uint8)


def _idat(png: bytes) -> bytes:
    pos, data = 8, b""
    while pos < len(png):
        n = struct.unpack(">I", png[pos:pos + 4])[0]
        if png[pos + 4:pos + 8] == b"IDAT":
            data += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    return zlib.decompress(data)


@pytest.mark.parametrize("color", sorted(CHANNELS))
def test_unfilter_every_filter_type_matches_numpy(tmp_path, color):
    rng = np.random.default_rng(color)
    h, w, c = 10, 9, CHANNELS[color]
    hi = 6 if color == 3 else 256
    samples = rng.integers(0, hi, (h, w, c), dtype=np.uint8)
    palette = rng.integers(0, 256, (6, 3)) if color == 3 else None
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4], [4, 3, 2, 1]):
        png = encode_png(samples, color, filters, palette)
        path = tmp_path / f"c{color}_{''.join(map(str, filters))}.png"
        path.write_bytes(png)
        ref = unfilter_reference(_idat(png), h, w * c, c).reshape(h, w, c)
        np.testing.assert_array_equal(ref, samples)
        if color == 3:
            want = palette[ref[..., 0]].astype(np.uint8)
        else:   # gray repeated, alpha dropped
            want = ref[..., [0, 0, 0]] if c < 3 else ref[..., :3]
        np.testing.assert_array_equal(native_loader.decode_png(str(path)), want)


def test_what_the_decoder_does_not_read_raises(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    cases = {
        "16bit": (encode_png(np.zeros((4, 4, 6), np.uint8), 2, [0], depth=16), "16-bit"),
        "adam7": (encode_png(img, 2, [0], interlace=1), "interlaced"),
        "gray4": (encode_png(np.zeros((4, 2, 1), np.uint8), 0, [0], depth=4), "8-bit"),
        "jpeg": (b"\xff\xd8\xff\xe0" + bytes(64), "not a PNG"),
        "cut": (encode_png(img, 2, [0])[:40], "truncated"),
        "index": (encode_png(np.full((4, 4, 1), 5, np.uint8), 3, [0],
                             np.zeros((2, 3), np.uint8)), "palette"),
    }
    for name, (data, what) in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        with pytest.raises(IOError, match=what) as e:
            native_loader.decode_half(str(path), (8, 8), 0)
        assert str(path) in str(e.value)


def _frames(rng, h: int, w: int, n: int):
    """n moving, textured RGB frames (H, W, 3)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    tex = rng.normal(0, 18, (h, w, 3)).astype(np.float32)
    for t in range(n):
        base = np.stack([128 + 90 * np.sin((x - 3 * t) / (7 + 5 * k) + (y + 2 * t) / 11.0)
                         for k in range(3)], -1)
        yield np.clip(base + np.roll(tex, t, axis=1), 0, 255).astype(np.uint8)


def _write_tree(root, clips: int, frames: int, h: int, w: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    for c in range(clips):
        d = root / f"clip{c:03d}"
        d.mkdir(parents=True)
        for t, img in enumerate(_frames(rng, h, w, frames)):
            (d / f"{t:05d}.png").write_bytes(encode_png(img, 2, [t % 5, (t + 1) % 5, 4]))
    return root


@pytest.mark.parametrize("hw", [(512, 1024), (360, 640), (720, 1280), (600, 800)])
def test_decode_half_matches_the_jax_decoder(tmp_path, hw):
    if not jnative.available():
        pytest.skip("native/libvideoload.so does not load here (it links OpenCV 4.6)")
    rng = np.random.default_rng(hw[0])
    exact = total = 0
    for t, img in enumerate(_frames(rng, hw[0], hw[1], 2)):
        path = tmp_path / f"{t}.png"
        path.write_bytes(encode_png(img, 2, [0, 1, 2, 3, 4][t:] + [0, 1, 2, 3, 4][:t]))
        for half in (0, 1):
            for out_hw in ((256, 256), (64, 64)):
                a = native_loader.decode_half(str(path), out_hw, half)
                b = jnative.decode_half(str(path), out_hw, half)
                gap = np.abs(a.astype(int) - b.astype(int))
                assert gap.max() <= 1, (hw, half, out_hw)
                exact, total = exact + int((gap == 0).sum()), total + gap.size
    share = exact / total
    print(f"decode_half at {hw[1]}x{hw[0]}: share exact against libvideoload {share:.6f}")
    if hw == (512, 1024):
        assert share == 1.0
    clip = native_loader.decode_clip(sorted(glob.glob(str(tmp_path / "*.png"))), (64, 64), 1,
                                     threads=2)
    assert clip.shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(clip[1], native_loader.decode_half(str(tmp_path / "1.png"),
                                                                     (64, 64), 1))


def _cfgs(root, **kw):
    base = dict(root_folder=str(root), frame_size=(32, 32), **kw)
    return JDataConfig(**base), DataConfig(**base)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("tree") / "LQ", clips=2, frames=50, h=48, w=96)


@pytest.mark.parametrize("native", [True, False])
def test_folder_readers_match_jax(tree, native):
    for stage_uint8 in (False, True):
        jc, tc = _cfgs(tree, use_native_loader=native, stage_uint8=stage_uint8)
        jd, td = jdataset.VideoFolderDataset(jc, seed=3), dataset.VideoFolderDataset(tc, seed=3)
        assert len(td) == len(jd) == 4
        for idx in (0, 3):
            for a, b in zip(td[idx], jd[idx]):
                assert a.dtype == b.dtype and a.shape == b.shape == (25, 32, 32, 3)
                tol = 1 if a.dtype == np.uint8 else 1 / 255 + 1e-6
                np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), atol=tol)
    jc, tc = _cfgs(tree, use_native_loader=native)
    jd, td = jdataset.ExplicitVideoDataset(jc, seed=5), dataset.ExplicitVideoDataset(tc, seed=5)
    for idx in (1, 2):
        t_item, j_item = td[idx], jd[idx]
        for a, b in zip(t_item[:3], j_item[:3]):
            assert a.shape == b.shape == (20, 32, 32, 3)
            np.testing.assert_allclose(a, b, atol=1 / 255 + 1e-6)
        for a, b in zip(t_item[3:], j_item[3:]):
            np.testing.assert_array_equal(a, b)


class Slow:
    """Item i is (i,) after a random sleep; raises at `fail_at`."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at
        self.rng = np.random.default_rng(0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(float(self.rng.uniform(0, 0.004)))
        if i == self.fail_at:
            raise KeyError(f"item {i} failed")
        return (np.array([i]),)


def test_prefetcher_order_errors_close_and_sharding():
    idx = list(np.random.default_rng(1).permutation(40))
    p = dataset.DevicePrefetcher(Slow(40), indices=idx, num_workers=5, depth=3,
                                 to_device=False)
    assert [int(x[0][0]) for x in p] == idx and p.wait_s >= 0
    p.close()
    # to_device on the CPU: CPU tensors
    p = dataset.DevicePrefetcher(Slow(6), num_workers=2, device="cpu")
    got = list(p)
    p.close()
    assert all(isinstance(x[0], torch.Tensor) and x[0].device.type == "cpu" for x in got)
    assert [int(x[0][0]) for x in got] == list(range(6))
    # a worker's exception is raised in the consumer
    p = dataset.DevicePrefetcher(Slow(20, fail_at=7), num_workers=3, to_device=False)
    with pytest.raises(KeyError, match="item 7 failed"):
        list(p)
    p.close()
    # closed early, with both queues full: every thread stops
    p = dataset.DevicePrefetcher(Slow(200), num_workers=4, depth=1, to_device=False)
    next(iter(p))
    time.sleep(0.1)
    p.close(timeout=5.0)
    assert not any(t.is_alive() for t in p._workers + [p._stager])
    assert p._host_q.empty() and p._device_q.empty()
    # sharding takes a data mesh (tests/test_torch_data_parallel.py), nothing else
    with pytest.raises(TypeError, match="Mesh"):
        dataset.DevicePrefetcher(Slow(2), sharding=object(), to_device=False)


def test_prefetcher_stress_more_workers_than_cores():
    """Twice as many workers as cores and a 1 us switch interval: every
    item arrives once, in order, and every thread stops."""
    n = 2 * (os.cpu_count() or 4)
    idx = list(np.random.default_rng(2).permutation(300))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        p = dataset.DevicePrefetcher(Slow(300), indices=idx, num_workers=n, depth=2,
                                     to_device=False)
        got = [int(x[0][0]) for x in p]
        p.close(timeout=10.0)
    finally:
        sys.setswitchinterval(old)
    assert got == idx
    assert not any(t.is_alive() for t in p._workers + [p._stager])


def test_rl_run_from_a_frame_tree(tmp_path, tree):
    c = _tiny_config(batch_size=2, frame=32, frames=5)
    c = from_dict(dataclasses.asdict(c.replace(
        model=dataclasses.replace(c.model, **tiny_model_overrides()))))
    cfg = c.replace(data=dataclasses.replace(c.data, root_folder=str(tree), num_workers=2),
                    run=dataclasses.replace(c.run, run_dir=str(tmp_path)))
    state = rl.run(cfg, dataset=dataset.VideoFolderDataset(cfg.data), iterations=2,
                   device="cpu")
    assert state.step == 2
    (metrics,) = glob.glob(str(tmp_path / "rovr_rl" / "*" / "metrics.jsonl"))
    recs = [json.loads(line) for line in open(metrics)]
    assert {r["step"] for r in recs} == {0, 1}
    assert all(np.isfinite(r["value"]) for r in recs)
    assert {"Episode/lpips_loss", "PPO/actor_loss", "Data/prefetch_wait_s"} <= \
        {r["tag"] for r in recs}
    (ck,) = glob.glob(str(tmp_path / "rovr_rl" / "*" / "checkpoints"))
    assert sorted(os.listdir(ck)) == ["0", "1"]
