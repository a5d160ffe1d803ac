"""Writers of small image files in every format the port's decoders read:
PNG at any colour type, bit depth and filter, Adam7-interlaced or not;
BMP at every header, bit count, bitfields layout and RLE; progressive
JPEG cut after some of its scans, and JPEG files re-labelled by their
Adobe marker (YCCK, which PIL never writes, and CMYK without the marker);
lossy WebP frames with the VP8 header fields PIL's encoder never sets
(`vp8_frame`), and animations of hand-placed frames (`animated_webp`);
and the seeded inputs behind the golden digests of tests/fixtures. Only
the tests and chip_smoke.py use them.

numpy, `struct` and `zlib` only: PIL writes no interlaced PNG, and the
card's host has neither PIL nor cv2. The format constants (Adam7's passes,
the BMP bitfields masks, VP8's probability tables) are the decoders' own,
from `image_io` and `webp`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from hifidiff_tpu_torch.data.image_io import ADAM7, BMP_MASKS
from hifidiff_tpu_torch.data.webp import (_BANDS, _BMODES_PROBA, _CATS,
                                          _COEFFS_PROBA0,
                                          _COEFFS_UPDATE_PROBA)


def golden_input(seed, h, w):
    """The seeded (h, w, 3) uint8 RGB image behind a golden encoder digest
    of tests/fixtures/jpeg/digests.json: three ramps with noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([x * 255 // max(1, w - 1), y * 255 // max(1, h - 1),
                     (x + y) * 255 // max(1, h + w - 2)], -1)
    return np.clip(base + rng.integers(-24, 25, base.shape), 0,
                   255).astype(np.uint8)


def jpeg_scans(data):
    """A JPEG file cut at its scans: (the bytes before the first SOS,
    [each scan's bytes, from its SOS to the next marker that is not an
    RSTn]); the file ends with EOI after them."""
    def segment_end(at):   # a marker segment's end
        return at + 2 + ((data[at + 2] << 8) | data[at + 3])

    at = 2
    while data[at + 1] != 0xDA:
        at = segment_end(at)
    head, scans = data[:at], []
    while data[at + 1] == 0xDA:
        end = segment_end(at)
        while not (data[end] == 0xFF and data[end + 1] not in (
                0x00, *range(0xD0, 0xD8))):
            end += 1
        scans.append(data[at:end])
        at = end
        while data[at + 1] not in (0xDA, 0xD9):   # DHT between scans
            scans[-1] += data[at:segment_end(at)]
            at = segment_end(at)
    return head, scans


def incomplete_progressive(data, keep=2):
    """A progressive JPEG with only its first `keep` scans, then EOI: a
    file libjpeg smooths, which the port refuses."""
    head, scans = jpeg_scans(data)
    return head + b"".join(scans[:keep]) + b"\xff\xd9"


def _adobe_segment(data):
    """(start, end) of a JPEG file's first Adobe APP14 segment."""
    at = 2
    while data[at + 1] != 0xDA:
        end = at + 2 + ((data[at + 2] << 8) | data[at + 3])
        if data[at + 1] == 0xEE and data[at + 4:at + 9] == b"Adobe":
            return at, end
        at = end
    raise ValueError("no Adobe APP14 segment before the first scan")


def jpeg_adobe_transform(data, transform):
    """A JPEG file with its Adobe marker's transform byte set to
    `transform`: libjpeg reads four components under transform 2 as YCCK
    (and turns them into CMYK), three under 0 as RGB. PIL writes no YCCK
    file; its CMYK files re-labelled are valid YCCK ones."""
    at, _ = _adobe_segment(data)
    return data[:at + 15] + bytes([transform]) + data[at + 16:]


def jpeg_without_adobe(data):
    """A JPEG file without its Adobe APP14 segment: libjpeg then reads
    four components as CMYK, and three with ids 'R', 'G', 'B' (and no
    JFIF marker) as RGB."""
    at, end = _adobe_segment(data)
    return data[:at] + data[end:]


def png_filtered(img, filters=(0, 1, 2, 3, 4), idat_size=8192, level=6):
    """A uint8 (H, W), (H, W, 2), (H, W, 3) or (H, W, 4) array as a PNG
    file's bytes (colour type 0, 4, 2 or 6, bit depth 8), row y filtered
    with `filters[y % len(filters)]` (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth), the image data split over IDAT chunks of `idat_size` bytes:
    files that take every path of the port's decoder."""
    img = img if img.ndim == 3 else img[..., None]
    return png_file(img, 8, {1: 0, 2: 4, 3: 2, 4: 6}[img.shape[2]],
                    filters=filters, idat_size=idat_size, level=level)


def png_file(samples, depth, color, interlace=0, filters=(0, 1, 2, 3, 4),
             palette=None, idat_size=8192, level=6):
    """An (H, W, channels) array of sample values (palette indices for
    colour type 3) as a PNG file's bytes at bit depth `depth` (1, 2, 4, 8
    or 16) and colour type `color`, non-interlaced or (`interlace=1`)
    Adam7: each pass's rows packed (16-bit samples big-endian) and filtered
    as `png_filtered` filters them, row y of each pass with
    `filters[y % len(filters)]`, a pass with no pixels left out. PIL writes
    no interlaced PNG (its `interlace` option is ignored)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = []
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        part = samples[y0::dy, x0::dx]
        ph, pw = part.shape[:2]
        if not ph or not pw:
            continue
        flat = part.reshape(ph, pw * ch).astype(np.uint32)
        if depth == 16:
            rows = flat.astype(">u2").view(np.uint8).reshape(ph, -1)
        elif depth == 8:
            rows = flat.astype(np.uint8)
        else:
            bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.reshape(ph, -1).astype(np.uint8), axis=1)
        rows = rows.astype(np.int16)
        up = np.zeros_like(rows)
        up[1:] = rows[:-1]
        left = np.zeros_like(rows)
        left[:, bpp:] = rows[:, :-bpp]
        corner = np.zeros_like(rows)
        corner[1:, bpp:] = rows[:-1, :-bpp]
        p = left + up - corner
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - corner)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, corner))
        pred = (np.zeros_like(rows), left, up, (left + up) // 2, paeth)
        kinds = np.array([filters[y % len(filters)] for y in range(ph)])
        out = np.empty((ph, rows.shape[1] + 1), np.uint8)
        out[:, 0] = kinds
        for k in range(5):
            out[kinds == k, 1:] = (rows[kinds == k]
                                   - pred[k][kinds == k]) % 256
        raw.append(out.tobytes())
    data = zlib.compress(b"".join(raw), level)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    plte = b"" if palette is None else chunk(
        b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                         interlace))
            + plte
            + b"".join(chunk(b"IDAT", data[i:i + idat_size])
                       for i in range(0, len(data), idat_size))
            + chunk(b"IEND", b""))


def _rle_row(row, rle4):
    """One row of palette indices as RLE8 / RLE4 codes, its end-of-line
    escape included: runs of equal values as encoded runs, stretches of
    four or more changing values as absolute runs (an even count of them
    in RLE4, padded to a 16-bit word), the rest as runs of one (RLE4: of
    one pair)."""
    out, x, w = bytearray(), 0, len(row)
    step = 2 if rle4 else 1
    while x < w:
        n = 1
        while x + n < w and n < 255 and row[x + n] == row[x]:
            n += 1
        if n >= 2 * step or x + step > w:
            out += bytes([n, row[x] * 17 if rle4 else row[x]])
            x += n
            continue
        m = 0      # an absolute stretch: up to the next run of three
        while x + m < w and m < 254 and not (
                x + m + 2 < w and row[x + m] == row[x + m + 1]
                == row[x + m + 2]):
            m += 1
        m -= m % step
        if m >= 4:
            vals = row[x:x + m]
            body = (bytes(int(a) << 4 | int(b) for a, b in
                          zip(vals[::2], vals[1::2])) if rle4
                    else bytes(int(v) for v in vals))
            out += bytes([0, m]) + body + b"\0" * (len(body) % 2)
            x += m
        elif rle4:
            b = row[x + 1] if x + 1 < w else 0
            out += bytes([min(2, w - x), int(row[x]) << 4 | int(b)])
            x += 2
        else:
            out += bytes([1, row[x]])
            x += 1
    return bytes(out) + b"\0\0"


def bmp_file(pixels, bits, header=40, topdown=False, palette=None,
             fields=None, rle=False):
    """A BMP file's bytes, as Windows and PIL write them: `pixels` is an
    (H, W) array of palette indices (bits 1, 4, 8; `palette` (k, 3) RGB,
    written BGRX, or BGR under the 12-byte core header), or (H, W, 3)
    uint8 RGB (bits 16, 24, 32: 16 bits 5-5-5 BI_RGB unless `fields`
    names a 16-bit layout of `image_io.BMP_MASKS`, written BI_BITFIELDS;
    32 bits BGRX BI_RGB, or a 32-bit layout of BMP_MASKS with alpha 255).
    `header` is 12, 40, 56, 108 or 124 bytes; `topdown` writes a negative
    height; `rle` (8 or 4 bits) writes RLE8 / RLE4 with `_rle_row`."""
    h, w = pixels.shape[:2]
    masks = BMP_MASKS[fields][1] if fields else None
    compression = 3 if masks else (1 if bits == 8 else 2) if rle else 0
    stride = ((w * bits + 31) >> 3) & ~3
    if rle:
        body = b"".join(_rle_row(r, bits == 4)
                        for r in (pixels if topdown else pixels[::-1]))
        body += b"\0\1"
    else:
        if bits <= 8:
            v = pixels.astype(np.uint32)
            bitv = (v[..., None] >> np.arange(bits - 1, -1, -1)) & 1
            rows = np.packbits(bitv.reshape(h, -1).astype(np.uint8), axis=1)
        elif bits == 16:
            r, g, b = (pixels[..., k].astype(np.uint32) for k in range(3))
            v = ((r >> 3) << 11 | (g >> 2) << 5 | b >> 3 if fields == "565"
                 else (r >> 3) << 10 | (g >> 3) << 5 | b >> 3)
            rows = v.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            nb = bits // 8
            rows = np.zeros((h, w, nb), np.uint8)
            m = masks or BMP_MASKS["BGRX"][1]
            for k in range(3):
                rows[..., m[k].bit_length() // 8 - 1] = pixels[..., k]
            if m[3]:
                rows[..., m[3].bit_length() // 8 - 1] = 255
            rows = rows.reshape(h, -1)
        padded = np.zeros((h, stride), np.uint8)
        padded[:, :rows.shape[1]] = rows
        body = (padded if topdown else padded[::-1]).tobytes()
    pal = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            pal = np.concatenate([pal, np.zeros_like(pal[:, :1])], 1)
        pal = pal.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if topdown else h,
                           1, bits, compression, len(body), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        if header > 40:
            info += struct.pack("<IIII", *(masks or (0, 0, 0, 0)))
            info += b"\0" * (header - 56)
            info = info[:header]
        elif masks:
            info += struct.pack("<III", *masks[:3])
    offset = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
            + info + pal + body)


# the progressive and CMYK JPEG of tests/fixtures/jpeg and the WebP files
# of tests/fixtures/webp among `celeba_file`'s kinds
CELEBA_PROGRESSIVE = "pil_prog_face_q95_160x160.jpg"
CELEBA_CMYK = "pil_cmyk_face_q90_160x160.jpg"
CELEBA_WEBP = ("lossy_face_q90_160x160.webp", "lossless_face_160x160.webp",
               "anim_lossy_alpha_face_160x160.webp")


def celeba_file(img, j, progressive, webps, cmyk):
    """The j-th file of a CelebA-HQ directory that mixes every format the
    port reads (chip_smoke.py phase 15's), (bytes, extension), of the uint8
    RGB face `img`, by j % 16: an 8-bit PNG of colour type 2
    (0, 6) or 6 (1, 7) through the five filters; an Adam7 8-bit RGB PNG
    (2, 8); a 16-bit Adam7 RGBA PNG of the samples times 257 (3) or a
    16-bit grey one of the green samples as they are (9); the progressive
    JPEG fixture `progressive` (4, 10); a 24-bit BMP (5) or an RLE8 BMP of
    the face on a 6 x 6 x 6 palette (11); the lossy (12), the lossless (13)
    or the animated (14) WebP fixture of `webps`; the CMYK JPEG fixture
    `cmyk` (15). CelebA-HQ is read as PIL reads it: the grey 16-bit file
    is the green channel, the CMYK file by PIL's CMYK -> RGB."""
    k = j % 16
    if k == 15:
        return cmyk, ".jpg"
    if k >= 12:
        return webps[k - 12], ".webp"
    if k in (0, 6):
        return png_filtered(img, level=1), ".png"
    if k in (1, 7):
        return png_filtered(np.concatenate(
            [img, np.full_like(img[..., :1], 255)], -1), level=1), ".png"
    if k in (2, 8):
        return png_file(img, 8, 2, interlace=1, level=1), ".png"
    if k == 3:
        rgba = np.concatenate([img, np.full_like(img[..., :1], 255)], -1)
        return png_file(rgba.astype(np.int64) * 257, 16, 6, interlace=1,
                        level=1), ".png"
    if k == 9:
        return png_file(img[..., 1:2], 16, 0, level=1), ".png"
    if k in (4, 10):
        return progressive, ".jpg"
    if k == 5:
        return bmp_file(img, 24), ".bmp"
    levels = (img.astype(np.int64) * 6) // 256
    idx = levels[..., 0] * 36 + levels[..., 1] * 6 + levels[..., 2]
    grid = np.arange(6) * 51
    palette = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"),
                       -1).reshape(216, 3)
    return bmp_file(idx, 8, palette=palette, rle=True), ".bmp"


# -- VP8 frames PIL's encoder never writes -----------------------------------

class _BoolWriter:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        k = len(self.out) - 1
        while self.out[k] == 255:
            self.out[k] = 0
            k -= 1
        self.out[k] += 1

    def put(self, bit, prob=128):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v, bits):
        for k in range(bits - 1, -1, -1):
            self.put((v >> k) & 1)

    def signed(self, v, bits):
        self.value(abs(v), bits)
        self.put(int(v < 0))

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _write_large(w, v, p):
    """The token of a coefficient magnitude v >= 2 (GetLargeValue's tree)."""
    if v <= 4:
        w.put(0, p[3])
        w.put(int(v > 2), p[4])
        if v > 2:
            w.put(int(v == 4), p[5])
    elif v <= 10:
        w.put(1, p[3])
        w.put(0, p[6])
        w.put(int(v > 6), p[7])
        if v <= 6:
            w.put(v - 5, 159)
        else:
            w.put((v - 7) >> 1, 165)
            w.put((v - 7) & 1, 145)
    else:
        cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
        w.put(1, p[3])
        w.put(1, p[6])
        w.put(cat >> 1, p[8])
        w.put(cat & 1, p[9 + (cat >> 1)])
        extra, probs = v - 3 - (8 << cat), _CATS[cat]
        for k, prob in enumerate(probs):
            w.put((extra >> (len(probs) - 1 - k)) & 1, prob)


def _write_tokens(w, bands, ctx, levels, first):
    """One block's coefficient levels (zigzag order) as GetCoeffs reads
    them; returns the index after the last one written (the decoder's
    `nz`)."""
    last = max((n for n in range(first, 16) if levels[n]), default=-1)
    n, p = first, bands[_BANDS[first]][ctx]
    while n < 16:
        if n > last:
            w.put(0, p[0])
            return n
        w.put(1, p[0])
        while not levels[n]:
            w.put(0, p[1])
            n += 1
            p = bands[_BANDS[n]][0]
        w.put(1, p[1])
        v = abs(levels[n])
        w.put(int(v > 1), p[2])
        if v > 1:
            _write_large(w, v, p)
        w.put(int(levels[n] < 0))
        n += 1
        p = bands[_BANDS[n]][2 if v > 1 else 1]
    return 16


def vp8_frame(seed, width, height, partitions=1, simple=False, level=24,
              sharpness=0, lf_deltas=None, segments=False):
    """A lossy WebP file (simple format) of one VP8 key frame with seeded
    random modes and coefficients, written with the header fields PIL's
    encoder never sets: `partitions` token partitions (1, 2, 4 or 8), the
    simple loop filter, `sharpness` 0-7, the reference and mode level
    deltas `lf_deltas` (8 ints, or None), four segments with their own
    quantizers, filter levels and map probabilities; some token
    probabilities updated, skip flags, and every 16x16, 4x4 and chroma
    mode. The decoder's tables (`data/webp.py`) give the trees' and
    tokens' probabilities."""
    rng = np.random.default_rng(seed)
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    hdr = _BoolWriter()
    hdr.value(0, 2)   # colour space, clamping type
    hdr.put(int(segments))
    seg_proba = rng.integers(1, 256, 3)
    if segments:
        hdr.put(1)    # update the map
        hdr.put(1)    # update the data
        hdr.put(0)    # deltas, not absolute values
        for q in rng.integers(-20, 21, 4):
            hdr.put(1)
            hdr.signed(int(q), 7)
        for f in rng.integers(-15, 16, 4):
            hdr.put(1)
            hdr.signed(int(f), 6)
        for p in seg_proba:
            hdr.put(1)
            hdr.value(int(p), 8)
    hdr.put(int(simple))
    hdr.value(level, 6)
    hdr.value(sharpness, 3)
    hdr.put(int(lf_deltas is not None))
    if lf_deltas is not None:
        hdr.put(1)
        for d in lf_deltas:
            hdr.put(1)
            hdr.signed(int(d), 6)
    hdr.value(int(partitions).bit_length() - 1, 2)
    hdr.value(int(rng.integers(10, 70)), 7)
    for d in rng.integers(-6, 7, 5):
        hdr.put(1)
        hdr.signed(int(d), 4)
    hdr.put(0)        # refresh_entropy_probs
    proba = np.frombuffer(_COEFFS_PROBA0, np.uint8).astype(int).reshape(
        4, 8, 3, 11)
    update = np.frombuffer(_COEFFS_UPDATE_PROBA, np.uint8).reshape(
        4, 8, 3, 11)
    for idx in np.ndindex(4, 8, 3, 11):
        change = rng.random() < 0.05
        hdr.put(int(change), int(update[idx]))
        if change:
            proba[idx] = int(rng.integers(1, 256))
            hdr.value(int(proba[idx]), 8)
    skip_p = int(rng.integers(1, 256))
    hdr.put(1)
    hdr.value(skip_p, 8)
    parts = [_BoolWriter() for _ in range(partitions)]
    intra_top = [0] * (4 * mb_w)
    nz_top = [[0] * 9 for _ in range(mb_w)]
    for mb_y in range(mb_h):
        intra_left, nz_left = [0] * 4, [0] * 9
        tok = parts[mb_y % partitions]
        for mb_x in range(mb_w):
            top = intra_top[4 * mb_x:4 * mb_x + 4]
            if segments:
                s = int(rng.integers(0, 4))
                hdr.put(s >> 1, int(seg_proba[0]))
                hdr.put(s & 1, int(seg_proba[1 + (s >> 1)]))
            skip = int(rng.random() < 0.15)
            hdr.put(skip, skip_p)
            i4x4 = int(rng.random() < 0.5)
            hdr.put(1 - i4x4, 145)
            if not i4x4:   # DC, VE, HE, TM by their tree
                ymode = int(rng.integers(0, 4))
                hdr.put(int(ymode in (1, 3)), 156)
                hdr.put(int(ymode in (1, 2)), 128 if ymode in (1, 3)
                        else 163)
                top, intra_left = [ymode] * 4, [ymode] * 4
            else:
                for y in range(4):
                    left = intra_left[y]
                    for x in range(4):
                        p = _BMODES_PROBA[(top[x] * 10 + left) * 9:][:9]
                        mode = int(rng.integers(0, 10))
                        path = {0: [(0, 0)], 1: [(1, 0), (0, 1)],
                                2: [(1, 0), (1, 1), (0, 2)],
                                3: [(1, 0), (1, 1), (1, 2), (0, 3), (0, 4)],
                                4: [(1, 0), (1, 1), (1, 2), (0, 3), (1, 4),
                                    (0, 5)],
                                5: [(1, 0), (1, 1), (1, 2), (0, 3), (1, 4),
                                    (1, 5)],
                                6: [(1, 0), (1, 1), (1, 2), (1, 3), (0, 6)],
                                7: [(1, 0), (1, 1), (1, 2), (1, 3), (1, 6),
                                    (0, 7)],
                                8: [(1, 0), (1, 1), (1, 2), (1, 3), (1, 6),
                                    (1, 7), (0, 8)],
                                9: [(1, 0), (1, 1), (1, 2), (1, 3), (1, 6),
                                    (1, 7), (1, 8)]}[mode]
                        for bit, k in path:
                            hdr.put(bit, p[k])
                        top[x] = left = mode
                    intra_left[y] = left
            intra_top[4 * mb_x:4 * mb_x + 4] = top
            uvmode = int(rng.integers(0, 4))   # DC, TM, VE, HE
            hdr.put(int(uvmode != 0), 142)
            if uvmode:
                hdr.put(int(uvmode != 2), 114)
                if uvmode != 2:
                    hdr.put(int(uvmode == 1), 183)
            tnz = nz_top[mb_x]
            if skip:
                tnz[:8] = nz_left[:8] = [0] * 8
                if not i4x4:
                    tnz[8] = nz_left[8] = 0
                continue

            def levels(first):
                out = [0] * 16
                for n in range(first, 16):
                    r = rng.random()
                    if r < 0.12:
                        out[n] = int(rng.integers(1, 3))
                    elif r < 0.16:
                        out[n] = int(rng.integers(3, 70))
                    elif r < 0.165:
                        out[n] = int(rng.integers(70, 600))
                    if rng.random() < 0.5:
                        out[n] = -out[n]
                if rng.random() < 0.3:
                    out = [0] * 16
                return out
            if not i4x4:
                nz = _write_tokens(tok, proba[1], tnz[8] + nz_left[8],
                                   levels(0), 0)
                tnz[8] = nz_left[8] = int(nz > 0)
                first, ac = 1, proba[0]
            else:
                first, ac = 0, proba[3]
            for y in range(4):
                lnz = nz_left[y]
                for x in range(4):
                    nz = _write_tokens(tok, ac, lnz + tnz[x], levels(first),
                                       first)
                    lnz = tnz[x] = int(nz > first)
                nz_left[y] = lnz
            for ch in (4, 6):
                for y in range(2):
                    lnz = nz_left[ch + y]
                    for x in range(2):
                        nz = _write_tokens(tok, proba[2], lnz + tnz[ch + x],
                                           levels(0), 0)
                        lnz = tnz[ch + x] = int(nz > 0)
                    nz_left[ch + y] = lnz
    first_part = hdr.flush()
    data = [p.flush() for p in parts]
    tag = (len(first_part) << 5) | 0x10   # key frame, profile 0, shown
    frame = (struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a"
             + struct.pack("<HH", width, height) + first_part
             + b"".join(struct.pack("<I", len(d))[:3] for d in data[:-1])
             + b"".join(data))
    chunk = b"VP8 " + struct.pack("<I", len(frame)) + frame \
        + b"\0" * (len(frame) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


# -- animated WebP of hand-placed frames --------------------------------------

def _riff_chunk(kind, payload):
    return kind + struct.pack("<I", len(payload)) + payload \
        + b"\0" * (len(payload) & 1)


def webp_frame_chunks(still):
    """The image chunks of a still WebP file (an ALPH chunk and a VP8
    chunk, or a VP8 or VP8L chunk): what an ANMF chunk holds."""
    if still[12:16] != b"VP8X":
        return still[12:]
    at, out = 30, b""
    while at < len(still):
        size = struct.unpack_from("<I", still, at + 4)[0]
        end = at + 8 + size + (size & 1)
        if still[at:at + 4] in (b"ALPH", b"VP8 ", b"VP8L"):
            out += still[at:end]
        at = end
    return out


def animated_webp(width, height, frames, background=0, loop=0, flags=0x12):
    """An animated WebP file of a `width` x `height` canvas (VP8X flags
    `flags`: animation and alpha), an ANIM chunk (`background`, an ARGB
    int, and `loop`) and one ANMF chunk a frame: (x, y, duration, bits,
    chunks), `x` and `y` even, `bits` the ANMF byte (2: do not blend, 1:
    dispose to the background), `chunks` a frame's image chunks
    (`webp_frame_chunks`), whose size the ANMF header repeats."""
    body = _riff_chunk(b"VP8X", bytes([flags, 0, 0, 0])
                       + (width - 1).to_bytes(3, "little")
                       + (height - 1).to_bytes(3, "little"))
    body += _riff_chunk(b"ANIM", struct.pack("<IH", background, loop))
    for x, y, duration, bits, chunks in frames:
        at = chunks.find(b"VP8")
        kind, head = chunks[at:at + 4], chunks[at + 8:at + 18]
        if kind == b"VP8L":
            v = int.from_bytes(head[1:5], "little")
            w, h = (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1
        else:
            w, h = (struct.unpack_from("<H", head, k)[0] & 0x3FFF
                    for k in (6, 8))
        body += _riff_chunk(b"ANMF", b"".join(
            v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1,
                                              duration))
            + bytes([bits]) + chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body
