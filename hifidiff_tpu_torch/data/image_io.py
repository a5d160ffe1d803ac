"""The port's image decoders for the files the Multi-PIE, CelebA-HQ and
K-Face datasets, `infer_cr` and the server read: PNG (the inverse of
`utils/logging.png_bytes` and much more) and BMP here, JPEG in
`data/jpeg.py`, WebP in `data/webp.py`; and `imread_rgb` / `decode_image`,
which pick the decoder by the file's signature and read the file as the
library a call site names reads it (`reader="cv2"` or `"pil"`).

The two libraries differ on three things, and `reader` settles them:

- 16-bit PNG samples (below);
- CMYK and YCCK JPEG: each turns libjpeg's CMYK into RGB by its own rule
  (`data/jpeg.py`), up to 2 levels apart, and a four-component file read
  without a reader raises `JPEGError`, naming both;
- EXIF orientation: `cv2.imread` flips and transposes a PNG, JPEG or WebP
  file by its EXIF Orientation tag, PIL's `convert("RGB")` does not. With
  `reader="cv2"` the decoded image takes the same step
  (`data/orientation.py`, after whichever decoder ran); with "pil" or
  without a reader it stays as decoded.

The call sites: `multipie.imread_f32`, the IDC set and the pretraining
Multi-PIE set read as cv2 reads; every other dataset read, `infer_cr` and
the server's image body read as PIL reads.

PNG: colour types 0 (grey), 2 (RGB), 3 (palette, with a `PLTE` of any
length up to 256), 4 (grey + alpha) and 6 (RGBA) at bit depths 8 and 16
(not 16 for palettes), and grey and palette files at bit depths 1, 2 and
4; non-interlaced and Adam7-interlaced files (seven passes, each
unfiltered on its own rows from a zero prior row; a pass with no columns
or no rows has no bytes); the five row filters (None, Sub, Up, Average,
Paeth) on 1-8 bytes a pixel; IDAT split over any number of chunks. Every
chunk's CRC is checked. The result is RGB uint8: grey is repeated over
the three channels and alpha is dropped, as `cv2.imread(path,
IMREAD_COLOR)` (flipped to RGB) and PIL's `convert("RGB")` give it.

16-bit samples: cv2 5.0 and PIL 12.1 cut them to 8 bits differently, so
`decode_png` takes `reader` too; a 16-bit file read without a reader
raises `PNGError` naming the argument. Measured on seeded files of each
colour type:

    colour type        cv2 (imread, IMREAD_COLOR)   PIL (convert("RGB"))
    0  grey            high byte                    min(sample, 255)
    2  RGB             high byte                    high byte
    4  grey + alpha    high byte                    high byte
    6  RGBA            high byte                    high byte

(PIL opens a 16-bit grey file as mode "I;16" and clamps it to 255 in
`convert`; it opens the others as "RGB" / "RGBA" from "RGB;16B",
"LA;16B" and "RGBA;16B", which keep the high byte.)

BMP (`decode_bmp`), as PIL 12.1 decodes it (`BmpImagePlugin.py`): the
12-byte OS/2 core header and the 40-, 52-, 56-, 64-, 108- (V4) and
124-byte (V5) info headers; bottom-up and top-down rows; 1-, 4- and 8-bit
palettes (indices past the palette read black; a palette that is PIL's
grey ramp is read as PIL reads it, in its "1" or "L" raw mode, whatever
the bit count); 24-bit and 32-bit `BI_RGB` (the fourth byte ignored);
`BI_BITFIELDS` at the masks PIL takes (16-bit 5-6-5 and 5-5-5, each field
times 255 over its maximum, rounded down; 24 / 32 bits with whole-byte
fields, alpha dropped); RLE8 and RLE4 with PIL's own reading of them (see
`csrc/host/image.cc`). What PIL refuses, and a few files only PIL's quirks
would read (RLE at another bit count, a palette past 256 entries), raise
`BMPError` naming them.

Interlaced files cut short, unknown filters, palette indices past PLTE
raise `PNGError`; so does anything that is not a PNG given to
`decode_png`. `imread_rgb` and `decode_image` refuse a file of another
format (GIF, TIFF, ...) with `ImageFormatError`, naming the formats the
port reads; every error here is a ValueError.

`decode_png` walks the chunks, checks their CRCs and inflates the image
data in Python (`zlib`, C code that releases the GIL), then makes one call
to the host library (`csrc/host/image.cc`, built by `data/host.py`) that
unfilters the rows and writes the RGB pixels; `decode_bmp` parses the
header in Python and makes one call for the pixels (and the RLE). ctypes
releases the GIL for them too, so loader threads decode in parallel.
`decode_png_plain` and `decode_bmp_plain` are the same decoders in numpy
and Python, the library's plain versions, bit for bit equal to it; only
tests and chip_smoke.py call them.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from hifidiff_tpu_torch.data import host, orientation, webp
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


class _BadFilter(Exception):
    """(row, filter type) of a row of an unknown filter."""


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The (height, stride) uint8 scanlines of one pass's part of the
    inflated IDAT stream, which holds height * (stride + 1) bytes."""
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
            raise _BadFilter(y, kind)
        out[y] = cur
        prior = out[y]
    return out


READERS = ("cv2", "pil")
# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class ImageFormatError(ValueError):
    """A file in a format the port does not read, naming those it reads."""


def _parse(data: bytes):
    """The header's (width, height, depth, colour, interlace), the palette
    (or None) and the inflated image data of a PNG file, every refusal
    raised."""
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
    if interlace > 1:
        raise PNGError(f"unknown interlace method {interlace}")
    if not (depth == 8 or (depth == 16 and color != 3)
            or (color in (0, 3) and depth in (1, 2, 4))):
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
    return (width, height, depth, color, interlace), palette, raw


def _passes(width, height, interlace):
    """(pass index, x0, y0, dx, dy, pass width, pass height) of each pass
    that has pixels: the whole image, or Adam7's non-empty passes."""
    for p, (x0, y0, dx, dy) in enumerate(ADAM7 if interlace
                                         else ((0, 0, 1, 1),)):
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw > 0 and ph > 0:
            yield p, x0, y0, dx, dy, pw, ph


def _stride(width, ch, depth):
    return (width * ch * depth + 7) // 8


def _wanted(width, height, depth, color, interlace):
    ch = _CHANNELS[color]
    return sum(ph * (_stride(pw, ch, depth) + 1)
               for *_, pw, ph in _passes(width, height, interlace))


def _short(n: int, wanted: int, interlace: int) -> PNGError:
    return PNGError(("interlaced (Adam7) " if interlace else "")
                    + f"image data holds {n} bytes, {wanted} wanted")


def _filter_error(interlace, p, y, kind) -> PNGError:
    where = f"pass {p + 1} row {y}" if interlace else f"row {y}"
    return PNGError(f"{where}: unknown filter type {kind}")


def _palette_past(top: int, palette: np.ndarray) -> PNGError:
    return PNGError(f"palette index {top} past the {len(palette)} entries "
                    "of PLTE")


def _check_reader(reader):
    if reader not in (None, *READERS):
        raise ValueError(f"reader must be one of {READERS}, got {reader!r}")


def _sixteen(depth: int, reader) -> bool:
    """Whether 16-bit grey saturates (PIL) rather than keep its high byte
    (cv2); raises where the file is 16-bit and no library was named."""
    _check_reader(reader)
    if depth == 16 and reader is None:
        raise PNGError("a 16-bit PNG: pass reader='cv2' or 'pil', the "
                       "library whose reading of 16-bit samples the call "
                       "site follows (they differ on grey files)")
    return reader == "pil"


def decode_png(data: bytes, reader=None) -> np.ndarray:
    """A PNG file's bytes as an (H, W, 3) uint8 RGB array; `reader`
    ("cv2" or "pil") names how a 16-bit file is cut to 8 bits (the EXIF
    orientation is `decode_image`'s step)."""
    (width, height, depth, color, interlace), palette, raw = _parse(data)
    saturate = _sixteen(depth, reader) and color == 0
    wanted = _wanted(width, height, depth, color, interlace)
    if len(raw) < wanted:
        raise _short(len(raw), wanted, interlace)
    out = np.empty((height, width, 3), np.uint8)
    if out.size == 0:
        return out
    pal = (np.zeros((1, 3), np.uint8) if palette is None
           else np.ascontiguousarray(palette))
    detail = (ctypes.c_int * 3)()
    code = host.library().hi_png_rgb(
        raw, len(raw), height, width, depth, color, pal.ctypes.data,
        len(pal) if palette is not None else 0, interlace, int(saturate),
        out.ctypes.data, detail)
    if code == 2:
        raise _filter_error(interlace, *detail)
    if code == 3:
        raise _palette_past(detail[0], palette)
    if code == host.NO_MEMORY:
        raise PNGError(f"out of memory decoding a {width} x {height} PNG")
    if code:
        raise RuntimeError(f"hi_png_rgb returned {code} on a header "
                           "_parse accepted")
    return out


def _pass_rgb(rows, width, height, depth, color, palette, saturate):
    """One pass's unfiltered (height, stride) rows as (height, width, 3)
    RGB, and the largest palette index (-1 without a palette)."""
    ch = _CHANNELS[color]
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :width * depth]
        bits = bits.reshape(height, width, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits * weights).sum(axis=2).astype(np.uint8)
        if color == 0:   # scaled to 8 bits: 1 -> 255, 2 -> 85, 4 -> 17
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
        pixels = samples[..., None]
    elif depth == 16:
        wide = rows[:, :width * ch * 2].reshape(height, width, ch, 2)
        if saturate:
            value = wide[..., 0].astype(np.int32) * 256 + wide[..., 1]
            pixels = np.minimum(value, 255).astype(np.uint8)
        else:
            pixels = wide[..., 0]
    else:
        pixels = rows.reshape(height, width, ch)
    if color == 3:
        idx = pixels[..., 0]
        top = int(idx.max(initial=0))   # past the palette: raised later
        return palette[np.minimum(idx, len(palette) - 1)], top
    if color in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=2), -1
    return pixels[..., :3], -1


def decode_png_plain(data: bytes, reader=None) -> np.ndarray:
    """`decode_png` in numpy and Python: its plain version."""
    (width, height, depth, color, interlace), palette, raw = _parse(data)
    saturate = _sixteen(depth, reader) and color == 0
    wanted = _wanted(width, height, depth, color, interlace)
    if len(raw) < wanted:
        raise _short(len(raw), wanted, interlace)
    ch = _CHANNELS[color]
    out = np.zeros((height, width, 3), np.uint8)
    at, top = 0, -1
    for p, x0, y0, dx, dy, pw, ph in _passes(width, height, interlace):
        stride = _stride(pw, ch, depth)
        try:
            rows = _unfilter(raw[at:at + ph * (stride + 1)], ph, stride,
                             max(1, ch * depth // 8))
        except _BadFilter as e:
            raise _filter_error(interlace, p, *e.args) from None
        at += ph * (stride + 1)
        rgb, pass_top = _pass_rgb(rows, pw, ph, depth, color, palette,
                                  saturate)
        top = max(top, pass_top)
        out[y0::dy, x0::dx] = rgb
    if color == 3 and top >= len(palette):
        raise _palette_past(top, palette)
    return out


# -- BMP ---------------------------------------------------------------------

BMP_SIGNATURE = b"BM"
_BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)
# The BI_BITFIELDS layouts PIL takes (BmpImagePlugin's MASK_MODES), by the
# raw mode it reads them in ("565" and "555" are its "BGR;16" and
# "BGR;15"): (bits, (red, green, blue, alpha masks)). At 24 and 32 bits red,
# green and blue are whole bytes, at the places their masks name (all-zero
# masks read BGRA); alpha is dropped.
BMP_MASKS = {
    "BGRX": (32, (0xFF0000, 0xFF00, 0xFF, 0x0)),
    "XBGR": (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)),
    "BGXR": (32, (0xFF000000, 0xFF00, 0xFF, 0x0)),
    "ABGR": (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
    "RGBA": (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    "BGRA": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "BGAR": (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)),
    "BGRA, no masks": (32, (0x0, 0x0, 0x0, 0x0)),
    "BGR": (24, (0xFF0000, 0xFF00, 0xFF, 0x0)),
    "565": (16, (0xF800, 0x7E0, 0x1F, 0x0)),
    "555": (16, (0x7C00, 0x3E0, 0x1F, 0x0)),
}
# hi_bmp_rgb's layouts
_INDEX, _BIT, _BYTE, _555, _565, _BYTES = range(6)
# PIL's limit past which it refuses an image (DecompressionBombError)
_BMP_MAX_PIXELS = 2 * 89478485


class BMPError(ValueError):
    """A BMP file the decoder cannot read, with the reason."""


def _bmp_parse(data: bytes) -> dict:
    """A BMP file's header as PIL reads it: {"width", "height", "topdown",
    "bits", "layout", "places", "palette" ((k, 3) uint8 RGB), "rle" (0, 1
    RLE8, 2 RLE4), "offset"}, every refusal raised."""
    if data[:2] != BMP_SIGNATURE:
        raise BMPError("not a BMP file (no BM signature)")
    if len(data) < 18:
        raise BMPError("truncated BMP header")
    offset, size = struct.unpack_from("<I", data, 10)[0], struct.unpack_from(
        "<I", data, 14)[0]
    if size not in _BMP_HEADERS:
        raise BMPError(f"unsupported BMP header size {size}")
    if len(data) < 14 + size:
        raise BMPError("truncated BMP header")
    topdown, colors, masks = False, 0, None
    if size == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", data, 18)
        compression, padding = 0, 3
    else:
        width, height, _, bits, compression = struct.unpack_from(
            "<IIHHI", data, 18)
        colors = struct.unpack_from("<I", data, 46)[0]
        padding = 4
        if data[25] == 0xFF:   # a negative height: rows top-down
            topdown, height = True, 2 ** 32 - height
        if compression == 3:
            if len(data) < 66 + (4 if size >= 56 else 0):
                raise BMPError("truncated BMP bitfield masks")
            masks = struct.unpack_from("<III", data, 54) + (
                struct.unpack_from("<I", data, 66) if size >= 56 else (0,))
    if not width or not height:
        raise BMPError(f"an empty BMP ({width} x {height}): PIL does not "
                       "open it")
    if width * height > _BMP_MAX_PIXELS:
        raise BMPError(f"a {width} x {height} BMP: past PIL's limit of "
                       f"{_BMP_MAX_PIXELS} pixels")
    colors = colors or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise BMPError(f"unsupported BMP bit depth {bits}")
    out = dict(width=width, height=height, topdown=topdown, bits=bits,
               layout=_BYTES, places=(2, 1, 0), rle=0, offset=offset,
               palette=np.zeros((1, 3), np.uint8))
    if compression == 3:
        key = (bits, masks if bits == 32 else masks[:3] + (0,))
        name = next((n for n, k in BMP_MASKS.items() if k == key), None)
        if name is None:
            raise BMPError(f"unsupported BMP bitfields layout: {bits} bits, "
                           f"masks {tuple(hex(m) for m in masks)}")
        if bits == 16:
            out["layout"] = _565 if name == "565" else _555
        elif any(masks[:3]):
            out["places"] = tuple(m.bit_length() // 8 - 1 for m in masks[:3])
    elif compression in (1, 2):
        want = 8 if compression == 1 else 4
        if bits != want:
            raise BMPError(f"RLE{want} BMP at {bits} bits a pixel is not "
                           "supported")
        out["rle"] = compression
    elif compression:
        named = {4: "JPEG", 5: "PNG"}.get(compression)
        raise BMPError(f"unsupported BMP compression {compression}"
                       + (f" ({named} inside a BMP)" if named else ""))
    elif bits == 16:
        out["layout"] = _555
    if bits <= 8:
        if colors > 256:
            raise BMPError(f"a BMP palette of {colors} entries")
        at = 14 + size
        raw = data[at:at + padding * colors]
        if len(raw) < padding * colors:
            raise BMPError("truncated BMP palette")
        pal = np.frombuffer(raw, np.uint8).reshape(colors, padding)[:, 2::-1]
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(pal[i].tolist() == [v] * 3 for i, v in enumerate(ramp)):
            out["layout"] = _BIT if colors == 2 else _BYTE
            if out["rle"] and colors == 2:
                raise BMPError("an RLE BMP of a black-and-white palette: "
                               "PIL cannot read it")
        else:
            out["layout"] = _INDEX
            out["palette"] = np.ascontiguousarray(pal)
    return out


def _bmp_refusal(code: int, detail) -> BMPError:
    if code == 1:
        return BMPError(f"truncated BMP pixel data: {detail[0]} bytes, "
                        f"{detail[1]} wanted")
    if code == 2:
        return BMPError(f"BMP RLE data ends after {detail[0]} of "
                        f"{detail[1]} pixels")
    if code == 3:
        return BMPError("BMP RLE data ends inside a delta escape")
    if code == host.NO_MEMORY:
        return BMPError("out of memory decoding the BMP")
    return BMPError(f"a BMP row of more bytes than its stride (PIL's raw "
                    f"mode on this palette); hi_bmp_rgb returned {code}")


def decode_bmp(data: bytes) -> np.ndarray:
    """A BMP file's bytes as an (H, W, 3) uint8 RGB array."""
    data = bytes(data)
    h = _bmp_parse(data)
    out = np.empty((h["height"], h["width"], 3), np.uint8)
    detail = (ctypes.c_int * 2)()
    code = host.library().hi_bmp_rgb(
        data, len(data), h["offset"], h["width"], h["height"],
        int(h["topdown"]), h["layout"], h["bits"], *h["places"],
        h["palette"].ctypes.data,
        len(h["palette"]) if h["layout"] == _INDEX else 0, h["rle"],
        out.ctypes.data, detail)
    if code:
        raise _bmp_refusal(code, detail)
    return out


def _bmp_rle_indices(data, h):
    """PIL's BmpRleDecoder: the indices, row after row as stored."""
    w, dest, rle4 = h["width"], h["width"] * h["height"], h["rle"] == 2
    px, pos, x = [], h["offset"], 0
    while len(px) < dest:
        if pos + 2 > len(data):
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = max(0, min(count, w - x))
            px += ([byte >> 4, byte & 15] * count)[:count] if rle4 \
                else [byte] * count
            x += count
        elif byte == 0:
            px += [0] * (-len(px) % w)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > len(data):
                break
            pos += 2
            if pos + 2 > len(data):
                raise _bmp_refusal(3, None)
            # clamped at dest: the loop stops there and px is cut there
            px += [0] * min(data[pos] + data[pos + 1] * w, dest - len(px))
            pos += 2
            x = len(px) % w
        else:
            want = byte // 2 if rle4 else byte
            got = data[pos:pos + want]
            px += [v for b in got for v in (b >> 4, b & 15)] if rle4 \
                else list(got)
            pos += len(got)
            if len(got) < want:
                break
            x += byte
            pos += pos % 2
    if len(px) < dest:
        raise _bmp_refusal(2, (len(px), dest))
    return np.array(px[:dest], np.uint8).reshape(h["height"], w)


def decode_bmp_plain(data: bytes) -> np.ndarray:
    """`decode_bmp` in numpy and Python: its plain version."""
    data = bytes(data)
    h = _bmp_parse(data)
    w, ht, bits, layout = h["width"], h["height"], h["bits"], h["layout"]
    if h["rle"]:
        values = _bmp_rle_indices(data, h)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        row_bytes = {_INDEX: (w * bits + 7) // 8, _BIT: (w + 7) // 8,
                     _BYTE: w, _555: 2 * w, _565: 2 * w}.get(
                         layout, w * (bits // 8))
        if row_bytes > stride:
            raise _bmp_refusal(4, None)
        wanted = (ht - 1) * stride + row_bytes
        there = max(0, len(data) - h["offset"])
        if there < wanted:
            raise _bmp_refusal(1, (min(there, 1 << 30), min(wanted, 1 << 30)))
        body = data[h["offset"]:h["offset"] + ht * stride]
        rows = np.frombuffer(body + bytes(ht * stride - len(body)),
                             np.uint8).reshape(ht, stride)
        if layout in (_INDEX, _BIT):
            per = bits if layout == _INDEX else 1
            unpacked = np.unpackbits(rows, axis=1)[:, :w * per]
            weights = (1 << np.arange(per - 1, -1, -1)).astype(np.int32)
            values = (unpacked.reshape(ht, w, per) * weights).sum(axis=2)
            if layout == _BIT:
                values = values * 255
        elif layout == _BYTE:
            values = rows[:, :w]
        elif layout in (_555, _565):
            v = rows[:, :2 * w].view("<u2").astype(np.int32)
            if layout == _565:
                rgb = [(v >> 11) & 31, (v >> 5) & 63, v & 31]
                top = (31, 63, 31)
            else:
                rgb = [(v >> 10) & 31, (v >> 5) & 31, v & 31]
                top = (31, 31, 31)
            values = np.stack([c * 255 // m for c, m in zip(rgb, top)], -1)
        else:
            px = rows[:, :w * (bits // 8)].reshape(ht, w, bits // 8)
            values = px[..., list(h["places"])]
    if values.ndim == 2:
        if layout == _INDEX:
            pal = h["palette"]
            values = np.where((values < len(pal))[..., None],
                              pal[np.minimum(values, len(pal) - 1)], 0)
        else:
            values = np.repeat(values[..., None], 3, axis=2)
    out = values.astype(np.uint8)
    return np.ascontiguousarray(out if h["topdown"] else out[::-1])


# -- by signature ------------------------------------------------------------

def decode_image(data: bytes, reader=None) -> np.ndarray:
    """A PNG, JPEG, WebP or BMP file's bytes, by their signature, as an
    (H, W, 3) uint8 RGB array, as `reader` ("cv2" or "pil") reads it: the
    16-bit rule of `decode_png`, the CMYK rule of `decode_jpeg`, and with
    "cv2" the EXIF orientation.
    Anything else raises `ImageFormatError`, naming what the port reads."""
    _check_reader(reader)
    data = bytes(data)
    if data[:2] == JPEG_SIGNATURE:
        img, exif = decode_jpeg(data, reader), orientation.jpeg_exif
    elif data[:8] == PNG_SIGNATURE:
        img, exif = decode_png(data, reader), orientation.png_exif
    elif data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        img = webp.decode_webp(data)

        def exif(d):
            block = webp.parse(d).exif
            return [] if block is None else [block]
    elif data[:2] == BMP_SIGNATURE:
        return decode_bmp(data)
    else:
        what = ("a GIF file" if data[:4] == b"GIF8" else "a TIFF file"
                if data[:4] in (b"II*\0", b"MM\0*")
                else "not an image the port knows")
        raise ImageFormatError(f"{what}: the port reads PNG, JPEG (baseline, "
                               "extended and progressive), WebP and BMP")
    if reader == "cv2":
        img = orientation.orient(img, orientation.cv2_orientation(exif(data)))
    return img


def imread_rgb(path: str, reader=None) -> np.ndarray:
    """The PNG, JPEG, WebP or BMP file at `path` as an (H, W, 3) uint8 RGB
    array, as `reader` reads it (`decode_image`); raises `PNGError`,
    `JPEGError`, `WebPError`, `BMPError` or `ImageFormatError` (each a
    ValueError) on what the decoders cannot read, and FileNotFoundError
    where there is no file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_image(data, reader)
    except (PNGError, JPEGError, webp.WebPError, BMPError,
            ImageFormatError) as e:
        raise type(e)(f"{path}: {e}") from None
