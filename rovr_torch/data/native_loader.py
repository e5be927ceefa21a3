"""The port's frame decoder (rovr_tpu/data/native_loader.py with
native/videoload.cc), with no OpenCV.

`decode_half(path, out_hw, half)` reads a PNG frame, resizes it to 1024x512,
takes its left (half 0) or right (half 1) 512x512 and resizes that to
`out_hw`: RGB uint8 (H, W, 3), the bytes `cv2.imread` + `cv2.resize` give
(video_ds.py:107-113). `decode_clip` decodes a list of frames on `threads`
threads.

Where the work runs: Python reads the file and inflates the IDAT stream with
the standard library's `zlib`; the chunk walk, the row unfiltering and the
two resizes are `csrc/frame_decode.cpp`, compiled by g++ at first use
(`ops/cuda_build`) and called through ctypes. zlib and ctypes both release
the GIL, so decode threads overlap each other and the training thread; the
Python between them is a handful of calls per frame.

What it reads: 8-bit PNGs, gray, RGB, palette, gray + alpha or RGBA (alpha
is dropped, as cv2.IMREAD_COLOR drops it), not interlaced. Any other file
raises IOError naming the file and what it lacks.
"""

from __future__ import annotations

import ctypes
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence, Tuple

import numpy as np

from rovr_torch.ops import cuda_build

_SOURCE = "frame_decode"
_INFO = 5   # width, height, bit depth, color type, palette entries

_ERRORS = {
    -1: "not a PNG file (bad signature)",
    -2: "a truncated PNG (a chunk runs past the end of the file)",
    -3: "a PNG without a valid IHDR chunk",
    -4: "a 16-bit PNG (the decoder reads 8-bit samples only)",
    -5: "a PNG of 1, 2 or 4 bits per sample (the decoder reads 8-bit samples only)",
    -6: "an interlaced PNG (the decoder reads non-interlaced files only)",
    -7: "a PNG of an unknown color type or compression/filter method",
    -8: "a PNG whose palette is missing, too long, or indexed past its end",
    -9: "a PNG whose image data is shorter than its rows",
    -10: "a PNG with a row filter type above 4",
    -11: "a PNG whose IDAT data is longer than the file",
}

_u8p = ctypes.POINTER(ctypes.c_uint8)
_intp = ctypes.POINTER(ctypes.c_int)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SOURCE)
    if lib.rovr_png_decode_half.argtypes is None:   # bound last: threads race here
        lib.rovr_png_chunks.restype = ctypes.c_int64
        lib.rovr_png_chunks.argtypes = [ctypes.c_char_p, ctypes.c_int64, _intp, _u8p,
                                        ctypes.c_int64, _u8p]
        lib.rovr_png_unfilter_rgb.restype = ctypes.c_int
        lib.rovr_png_unfilter_rgb.argtypes = [ctypes.c_char_p, ctypes.c_int64, _intp,
                                              _u8p, _u8p]
        lib.rovr_png_decode_half.restype = ctypes.c_int
        lib.rovr_png_decode_half.argtypes = [ctypes.c_char_p, ctypes.c_int64, _intp, _u8p,
                                             ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p]
    return lib


def _ptr(a: np.ndarray, kind=_u8p):
    return a.ctypes.data_as(kind)


def _check(rc: int, path: str) -> None:
    if rc < 0:
        raise IOError(f"{path}: {_ERRORS.get(rc, f'decode error {rc}')}")


def _inflate(path: str):
    """(inflated IDAT bytes, info (5,) int32, palette (768,) uint8) of the
    PNG at `path`."""
    lib = _lib()
    with open(path, "rb") as f:
        data = f.read()
    info = np.zeros(_INFO, np.int32)
    palette = np.zeros(768, np.uint8)
    idat = np.empty(len(data), np.uint8)
    n = lib.rovr_png_chunks(data, len(data), _ptr(info, _intp), _ptr(idat), len(data),
                            _ptr(palette))
    _check(n, path)
    try:
        raw = zlib.decompress(idat[:n])
    except zlib.error as e:
        raise IOError(f"{path}: corrupt PNG image data ({e})") from e
    return raw, info, palette


def decode_png(path: str) -> np.ndarray:
    """The PNG at `path` as RGB uint8 (H, W, 3), at its own size."""
    raw, info, palette = _inflate(path)
    rgb = np.empty((int(info[1]), int(info[0]), 3), np.uint8)
    _check(_lib().rovr_png_unfilter_rgb(raw, len(raw), _ptr(info, _intp), _ptr(palette),
                                        _ptr(rgb)), path)
    return rgb


def decode_half(path: str, out_hw: Tuple[int, int], half: int) -> np.ndarray:
    """Decode one frame -> resize to 1024x512 -> take half `half` (0 left,
    1 right) -> resize to out_hw. RGB uint8 (H, W, 3) (video_ds.py:107-113)."""
    if half not in (0, 1):
        raise ValueError(f"half must be 0 or 1, got {half}")
    h, w = out_hw
    raw, info, palette = _inflate(path)
    out = np.empty((h, w, 3), np.uint8)
    _check(_lib().rovr_png_decode_half(raw, len(raw), _ptr(info, _intp), _ptr(palette),
                                       half, h, w, _ptr(out)), path)
    return out


def decode_clip(paths: Sequence[str], out_hw: Tuple[int, int], half: int,
                threads: int = 4) -> np.ndarray:
    """`decode_half` of every path, on `threads` threads: uint8 (S, H, W, 3)."""
    h, w = out_hw
    out = np.empty((len(paths), h, w, 3), np.uint8)

    def one(i: int) -> None:
        out[i] = decode_half(paths[i], out_hw, half)

    with ThreadPoolExecutor(max(1, min(threads, len(paths)))) as pool:
        for f in [pool.submit(one, i) for i in range(len(paths))]:
            f.result()
    return out
