"""The port's JPEG codec: `decode_jpeg` and `encode_jpeg`, bound to the
host library built from `csrc/host/jpeg.cc` (`data/host.py`).

`decode_jpeg` gives what libjpeg-turbo gives at its defaults, bit for bit,
as RGB: what PIL's `Image.open(f).convert("RGB")` and cv2's
`imdecode(buf, IMREAD_COLOR)` (flipped to RGB) read. Baseline and
extended-sequential 8-bit Huffman files, every sampling up to 2x2 (4:4:4,
4:2:2, 4:4:0, 4:2:0) and whole ratios past it, grey (repeated over three
channels), restart intervals and any size. EXIF orientation is ignored, as
`Image.open` ignores it. Progressive, lossless, hierarchical and
arithmetic-coded files, 12-bit samples, CMYK / YCCK / RGB-coded
components and truncated data raise `JPEGError` naming what they are.

`encode_jpeg` gives the bytes of `cv2.imencode(".jpg", img,
[IMWRITE_JPEG_QUALITY, q])` for the same pixels (cv2 takes them as BGR):
4:2:0, the Annex K tables scaled to `q`, the standard Huffman tables, a
JFIF header.
"""

from __future__ import annotations

import ctypes

import numpy as np

from hifidiff_tpu_torch.data import host

JPEG_SIGNATURE = b"\xff\xd8"


class JPEGError(ValueError):
    """A file the decoder cannot read, or an image the encoder cannot
    write, with the reason."""


def _take(lib, ptr: int, nbytes: int) -> bytes:
    try:
        return ctypes.string_at(ptr, nbytes)
    finally:
        lib.hj_free(ptr)


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG file's bytes as an (H, W, 3) uint8 RGB array."""
    lib = host.library()
    data = bytes(data)
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    ptr = lib.hj_decode(data, len(data), ctypes.byref(h), ctypes.byref(w),
                        err, len(err))
    if not ptr:
        raise JPEGError(err.value.decode())
    raw = _take(lib, ptr, h.value * w.value * 3)
    return np.frombuffer(raw, np.uint8).reshape(h.value, w.value, 3).copy()


def encode_jpeg(img: np.ndarray, quality: int) -> bytes:
    """An (H, W, 3) uint8 RGB image as JPEG bytes at `quality` (1-100)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise JPEGError(f"encode_jpeg takes (H, W, 3) uint8, got "
                        f"{img.shape} {img.dtype}")
    img = np.ascontiguousarray(img)
    lib = host.library()
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    ptr = lib.hj_encode(img.ctypes.data, img.shape[0], img.shape[1],
                        int(quality), ctypes.byref(size), err, len(err))
    if not ptr:
        raise JPEGError(err.value.decode())
    return _take(lib, ptr, size.value)
