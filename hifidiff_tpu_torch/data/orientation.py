"""EXIF orientation as `cv2.imread` applies it (cv2 5.0), for the port's
cv2 call sites: `multipie.imread_f32`, the IDC set and the pretraining
Multi-PIE set read through `image_io.imread_rgb(..., reader="cv2")`. PIL's
`convert("RGB")` ignores orientation, so the PIL sites are not rotated.

Where cv2 finds the EXIF data (measured with cv2 5.0 on hand-made files):

    PNG   the first eXIf chunk libpng keeps, before or after IDAT: at least
          4 bytes opening with "II*\\0" or "MM\\0*" (libpng drops others and
          keeps looking; later ones are duplicates it ignores)
    JPEG  every APP1 segment before the first SOS that opens with
          "Exif\\0\\0", in file order, the TIFF data after those 6 bytes
    WebP  the first EXIF chunk of a VP8X file whose EXIF flag (0x08) is
          set, the raw TIFF data (no "Exif\\0\\0" prefix)

and how it reads them (OpenCV's ExifReader): byte order II when the first
two bytes are both "I", else big-endian; the magic 42; IFD0 at the offset
in bytes 4-7; then its entries in order, each 12 bytes, until one reads
past the data. Orientation (0x0112) is the 16-bit value at the entry's
bytes 8-9, whatever its type and count; the first one read wins, across
the JPEG's APP1 segments too. cv2 also reads a few other tags, and one
whose data lies past the end stops the walk before any later entry: the
strings 0x010E, 0x010F, 0x0110, 0x0131, 0x0132 and 0x8298 (their count in
bytes, inline up to 4 bytes, read at TIFF offset 8, else at the offset in
the entry), and the rationals 0x011A and 0x011B (8 bytes), 0x013E (16),
0x0211 (24), 0x013F and 0x0214 (48) at the offset in the entry.

Values 2-8 flip and transpose the image as cv2's ExifTransform does; 1,
0, 9 and above, no tag and EXIF data cv2 cannot parse leave it as
decoded. cv2 never fails a read over its EXIF data, and neither does this.
"""

from __future__ import annotations

import struct

import numpy as np

ORIENTATION = 0x0112
# cv2's tags that read data beyond the entry: string tags, and the rational
# tags with the bytes they read at the entry's offset
_STRINGS = (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298)
_RATIONALS = {0x011A: 8, 0x011B: 8, 0x013E: 16, 0x0211: 24, 0x013F: 48,
              0x0214: 48}


class _Past(Exception):
    """A read past the EXIF data: cv2's ExifParsingError."""


def tiff_orientation(tiff: bytes):
    """The orientation cv2 reads from one TIFF block, or None where the
    walk ends before an orientation entry."""
    n = len(tiff)
    endian = "<" if n > 1 and tiff[0] == tiff[1] == ord("I") else ">"

    def u16(at):
        if at + 1 >= n:
            raise _Past
        return struct.unpack_from(endian + "H", tiff, at)[0]

    def u32(at):
        if at + 3 >= n:
            raise _Past
        return struct.unpack_from(endian + "I", tiff, at)[0]

    try:
        if u16(2) != 42:
            return None
        at = u32(4)
        count = u16(at)
        at += 2
        for _ in range(count):
            tag = u16(at)
            if tag == ORIENTATION:
                return u16(at + 8)
            if tag in _STRINGS:
                size = u32(at + 4)
                start = 8 if size <= 4 else u32(at + 8)
                if start > n or start + size > n:
                    raise _Past
            elif tag in _RATIONALS:
                start = u32(at + 8)
                u32(start + _RATIONALS[tag] - 4)
            at += 12
    except _Past:
        return None
    return None


def png_exif(data: bytes) -> list:
    """The eXIf chunk cv2 reads from a PNG file (at most one)."""
    pos = 8
    while pos + 12 <= len(data):
        n, = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"eXIf" and len(body) >= 4 and body[:4] in (
                b"II*\0", b"MM\0*"):
            return [body]
        if kind == b"IEND":
            break
        pos += 12 + n
    return []


def jpeg_exif(data: bytes) -> list:
    """Each APP1 "Exif" block before the first SOS of a JPEG file."""
    blocks, pos = [], 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):
            break
        length, = struct.unpack_from(">H", data, pos + 2)
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body[:6] == b"Exif\0\0":
            blocks.append(body[6:])
        pos += 2 + length
    return blocks


def cv2_orientation(blocks) -> int:
    """The orientation cv2 applies from a file's EXIF blocks, 1 for none."""
    for tiff in blocks:
        value = tiff_orientation(tiff)
        if value is not None:
            return value
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """`img` (H, W, C) as cv2's ExifTransform leaves it for `orientation`."""
    t = img.transpose(1, 0, 2) if orientation in (5, 6, 7, 8) else img
    if orientation in (2, 6):
        t = t[:, ::-1]
    elif orientation in (3, 7):
        t = t[::-1, ::-1]
    elif orientation in (4, 8):
        t = t[::-1]
    return np.ascontiguousarray(t)
