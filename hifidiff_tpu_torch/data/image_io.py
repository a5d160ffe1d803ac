"""The port's PNG decoder: the inverse of `utils/logging.png_bytes`, for
the image files the Multi-PIE and CelebA-HQ datasets, `infer_cr` and the
server read; and `imread_rgb`, which reads a PNG with it and a JPEG with
the port's codec (`data/jpeg.py`), by the file's signature.

It reads colour types 0 (grey), 2 (RGB), 3 (palette, with a `PLTE` of any
length up to 256), 4 (grey + alpha) and 6 (RGBA) at bit depth 8, and grey
and palette files at bit depths 1, 2 and 4; the five row filters (None,
Sub, Up, Average, Paeth); IDAT split over any number of chunks. Every
chunk's CRC is checked. The result is RGB uint8: grey is repeated over the
three channels and alpha is dropped, as `cv2.imread(path, IMREAD_COLOR)`
(flipped to RGB) and PIL's `convert("RGB")` give it.

Interlaced (Adam7) files and 16-bit samples raise `PNGError` naming them;
so does anything that is not a PNG. `imread_rgb` refuses a file that is
neither PNG nor JPEG (BMP, WebP, ...), naming the two it reads.

`decode_png` walks the chunks, checks their CRCs and inflates the image
data in Python (`zlib`, C code that releases the GIL), then makes one call
to the host library (`csrc/host/image.cc`, built by `data/host.py`) that
unfilters the rows and writes the RGB pixels; ctypes releases the GIL for
it too, so loader threads decode in parallel. `decode_png_plain` is the
same decoder in numpy and Python, the library's plain version, bit for bit
equal to it; only tests and chip_smoke.py call it.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from hifidiff_tpu_torch.data import host
from hifidiff_tpu_torch.data.jpeg import JPEG_SIGNATURE, JPEGError, decode_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PNGError(ValueError):
    """A file the decoder cannot read, with the reason."""


def _chunks(data: bytes):
    if data[:8] != PNG_SIGNATURE:
        raise PNGError("not a PNG file (no PNG signature)")
    pos = 8
    while pos + 12 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise PNGError(f"truncated {kind!r} chunk")
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(body, zlib.crc32(kind)) != crc:
            raise PNGError(f"bad CRC in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise PNGError("no IEND chunk: the file is truncated")


def _average(line: bytes, prior: bytes, bpp: int) -> bytearray:
    """Average: each byte lane of the row runs on the reconstructed byte
    bpp to its left (0 before the row) and the byte above."""
    out = bytearray(len(line))
    for lane in range(bpp):
        a, lane_out = 0, []
        put = lane_out.append
        for x, b in zip(line[lane::bpp], prior[lane::bpp]):
            a = (x + ((a + b) >> 1)) & 0xFF
            put(a)
        out[lane::bpp] = bytes(lane_out)
    return out


def _paeth(line: bytes, prior: bytes, bpp: int) -> bytearray:
    """Paeth, lane by lane as `_average`: the predictor is the one of left
    (a), above (b) and upper left (c) nearest to a + b - c, ties going to
    a, then b."""
    out = bytearray(len(line))
    for lane in range(bpp):
        a = c = 0
        lane_out = []
        put = lane_out.append
        for x, b in zip(line[lane::bpp], prior[lane::bpp]):
            pa, pb = b - c, a - c     # |p - a|, |p - b| before the sign
            pc = pa + pb              # p - c
            if pa < 0:
                pa = -pa
            if pb < 0:
                pb = -pb
            if pc < 0:
                pc = -pc
            if pa <= pb and pa <= pc:
                a = (x + a) & 0xFF
            elif pb <= pc:
                a = (x + b) & 0xFF
            else:
                a = (x + c) & 0xFF
            put(a)
            c = b
        out[lane::bpp] = bytes(lane_out)
    return out


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The (height, stride) uint8 scanlines of the inflated IDAT stream."""
    if len(raw) < height * (stride + 1):
        raise _short(raw, height, stride)
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:    # Sub: a running sum per byte lane, mod 256
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(
                -1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[
                :stride]
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            cur = np.frombuffer((_average if kind == 3 else _paeth)(
                line.tobytes(), prior.tobytes(), bpp), np.uint8)
        else:
            raise PNGError(f"row {y}: unknown filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def _parse(data: bytes):
    """The header's (width, height, depth, colour), the palette (or None)
    and the inflated image data of a PNG file, every refusal raised."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or not 0 < len(body) <= 768:
                raise PNGError(f"PLTE of {len(body)} bytes")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError("no IHDR chunk")
    width, height, depth, color, compression, flt, interlace = header
    if color not in _CHANNELS:
        raise PNGError(f"unknown colour type {color}")
    if interlace:
        raise PNGError("interlaced (Adam7) PNG files are not supported")
    if depth == 16:
        raise PNGError("16-bit PNG files are not supported")
    if depth != 8 and not (color in (0, 3) and depth in (1, 2, 4)):
        raise PNGError(f"bit depth {depth} with colour type {color} is not "
                       "a valid PNG")
    if compression or flt:
        raise PNGError(f"unknown compression {compression} or filter "
                       f"method {flt}")
    if color == 3 and palette is None:
        raise PNGError("a palette file without PLTE")
    if not idat:
        raise PNGError("no IDAT chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"bad image data: {e}") from e
    return (width, height, depth, color), palette, raw


def _short(raw: bytes, height: int, stride: int) -> PNGError:
    return PNGError(f"image data holds {len(raw)} bytes, "
                    f"{height * (stride + 1)} wanted")


def _palette_past(top: int, palette: np.ndarray) -> PNGError:
    return PNGError(f"palette index {top} past the {len(palette)} entries "
                    "of PLTE")


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes as an (H, W, 3) uint8 RGB array."""
    (width, height, depth, color), palette, raw = _parse(data)
    stride = (width * _CHANNELS[color] * depth + 7) // 8
    if len(raw) < height * (stride + 1):
        raise _short(raw, height, stride)
    out = np.empty((height, width, 3), np.uint8)
    if out.size == 0:
        return out
    pal = (np.zeros((1, 3), np.uint8) if palette is None
           else np.ascontiguousarray(palette))
    detail = (ctypes.c_int * 2)()
    code = host.library().hi_png_rgb(
        raw, len(raw), height, width, depth, color, pal.ctypes.data,
        len(pal) if palette is not None else 0, out.ctypes.data, detail)
    if code == 2:
        raise PNGError(f"row {detail[0]}: unknown filter type {detail[1]}")
    if code == 3:
        raise _palette_past(detail[0], palette)
    if code:
        raise RuntimeError(f"hi_png_rgb returned {code} on a header "
                           "_parse accepted")
    return out


def decode_png_plain(data: bytes) -> np.ndarray:
    """`decode_png` in numpy and Python: its plain version."""
    (width, height, depth, color), palette, raw = _parse(data)
    ch = _CHANNELS[color]
    stride = (width * ch * depth + 7) // 8
    rows = _unfilter(raw, height, stride, max(1, ch * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :width * depth]
        bits = bits.reshape(height, width, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits * weights).sum(axis=2).astype(np.uint8)
        if color == 0:   # scaled to 8 bits: 1 -> 255, 2 -> 85, 4 -> 17
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
        pixels = samples[..., None]
    else:
        pixels = rows.reshape(height, width, ch)
    if color == 3:
        idx = pixels[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise _palette_past(int(idx.max()), palette)
        return palette[idx]
    if color in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def imread_rgb(path: str) -> np.ndarray:
    """The PNG or JPEG file at `path` as an (H, W, 3) uint8 RGB array;
    raises `PNGError` or `JPEGError` on what the decoders cannot read, and
    FileNotFoundError where there is no file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == JPEG_SIGNATURE:
        decode, error = decode_jpeg, JPEGError
    elif data[:8] == PNG_SIGNATURE:
        decode, error = decode_png, PNGError
    else:
        raise PNGError(f"{path}: neither PNG nor JPEG (the two formats the "
                       "port reads)")
    try:
        return decode(data)
    except error as e:
        raise error(f"{path}: {e}") from None
