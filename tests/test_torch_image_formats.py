"""The image formats the port's decoders read beyond baseline JPEG and
8-bit non-interlaced PNG, on the CPU: progressive JPEG (`data/jpeg.py`,
`csrc/host/jpeg.cc`), Adam7-interlaced and 16-bit PNG and BMP
(`data/image_io.py`, `csrc/host/image.cc`), held to PIL 12.1 and cv2 5.0
and to their plain versions; `imread_rgb` / `decode_image` by signature;
and the golden fixtures of tests/fixtures/{jpeg,png,bmp} that
`chip_smoke.py` phase 19 holds the host library to on the card's host,
where neither PIL nor cv2 exists.

Tolerances: none. Every decode is bit-equal to its yardstick:
  * progressive JPEG to `cv2.imdecode` (flipped to RGB) and PIL's
    `convert("RGB")`, on files both write, and the coefficients the host
    library's scans leave (`jpeg.coefficients`) equal to the Python
    decoder's (`jpeg.coefficients_plain`), baseline files too;
  * PNG at every colour type and bit depth, Adam7 or not: to PIL with
    `reader="pil"` and to cv2 with `reader="cv2"`, and
    `decode_png` to `decode_png_plain`;
  * BMP at every variant it takes: to PIL, and `decode_bmp` to
    `decode_bmp_plain`; seeded RLE8 / RLE4 streams, broken ones among them,
    refused where PIL raises, with one message from both versions.

EXIF orientation (`data/orientation.py`): every orientation of a PNG,
JPEG and WebP file read with `reader="cv2"` equal to `cv2.imread`, with
"pil" or no reader to PIL's unrotated `convert("RGB")`; the edges cv2
was measured at (an eXIf chunk after IDAT, values 0 and 9, cut and
looping IFDs, two APP1 segments, tags whose data lies past the end) and
200 seeded random EXIF blocks, each against `cv2.imread` itself.

`python tests/test_torch_image_formats.py` writes the PNG and BMP
fixtures (by `data/image_files.py`'s writers), the progressive JPEG fixtures
(by PIL and cv2), the orientation fixtures (by PIL) and the digests of all
four directories; the tests rebuild the PNG, BMP and orientation files byte
for byte and every digest with PIL and cv2.
"""

import ctypes
import hashlib
import io
import json
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from hifidiff_tpu_torch.data import host, image_io, jpeg, webp  # noqa: E402
from hifidiff_tpu_torch.data.image_files import (  # noqa: E402
    CELEBA_CMYK, CELEBA_PROGRESSIVE, CELEBA_WEBP, bmp_file, celeba_file,
    golden_input,
    incomplete_progressive, jpeg_adobe_transform, jpeg_scans,
    jpeg_without_adobe, png_file, png_filtered)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"


CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}


def _seed(*case):
    return zlib.crc32(repr(case).encode())


def _sha(rgb):
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _cv2(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]


def _same(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape,
                                                               want.shape)
    assert got.tobytes() == want.tobytes(), int(np.abs(
        got.astype(int) - want.astype(int)).max())


# -- writers ------------------------------------------------------------------

SAMPLING = {"444": 0, "422": 1, "420": 2}
CV2_SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def pil_progressive(img, quality, sampling="420"):
    """PIL's progressive JPEG of an RGB (or 2-D grey) uint8 image."""
    out = io.BytesIO()
    kw = {} if img.ndim == 2 else {"subsampling": SAMPLING[sampling]}
    Image.fromarray(img).save(out, "JPEG", quality=quality,
                              progressive=True, **kw)
    return out.getvalue()


def pil_baseline(img, quality):
    """PIL's baseline JPEG (4:2:0) of an RGB uint8 image."""
    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", quality=quality)
    return out.getvalue()


def cmyk_of(img):
    """An RGB uint8 image as CMYK: C, M, Y = 255 - R, G, B, less 60% of
    their common part, which K takes."""
    cmy = 255 - img.astype(np.int64)
    k = cmy.min(-1, keepdims=True) * 3 // 5
    return np.concatenate([cmy - k, k], -1).astype(np.uint8)


def pil_cmyk(img, quality, sampling="444", progressive=False):
    """PIL's CMYK JPEG of an RGB uint8 image (`cmyk_of`): Adobe transform 0,
    its samples inverted as Photoshop writes them; PIL's subsampling
    applies to the first three components, K stays at 1x1."""
    out = io.BytesIO()
    Image.fromarray(cmyk_of(img), "CMYK").save(
        out, "JPEG", quality=quality, subsampling=SAMPLING[sampling],
        progressive=progressive)
    return out.getvalue()


def pil_rgb_coded(img, quality):
    """PIL's RGB-coded JPEG (`keep_rgb=True`: Adobe transform 0, component
    ids 'R', 'G', 'B', no JFIF marker) of an RGB uint8 image."""
    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", quality=quality, keep_rgb=True)
    return out.getvalue()


def cv2_progressive(img, quality, sampling="420", restart=0):
    """cv2's progressive JPEG (IMWRITE_JPEG_PROGRESSIVE) of an RGB (or
    2-D grey) uint8 image, with a restart interval of `restart` MCUs."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE,
              1, cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, CV2_SAMPLING[sampling]]
        img = img[..., ::-1]
    return cv2.imencode(".jpg", np.ascontiguousarray(img), params)[1].tobytes()


def png_case(color, depth, h, w, interlace, seed):
    """A seeded PNG (png_file) of colour type `color` at bit
    depth `depth`: smooth ramps with noise over the depth's range (palette
    indices for type 3, with a PLTE one entry short of the depth's range
    where it has one), rows through the five filters."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    ch = CHANNELS[color]
    y, x = np.mgrid[:h, :w]
    ramps = np.stack([(x * 7 + y * 3 + 11 * k) % (w + h + 1) for k in
                      range(ch)], -1) * top // (w + h)
    noise = rng.integers(-(top // 8) - 1, top // 8 + 2, ramps.shape)
    samples = np.clip(ramps + noise, 0, top)
    palette = None
    if color == 3:
        entries = min(top + 1, 200)
        samples = samples % entries
        palette = rng.integers(0, 256, (entries, 3))
    return png_file(samples, depth, color, interlace, palette=palette)


# -- progressive JPEG ---------------------------------------------------------

SIZES = [(161, 157), (1, 1), (2, 3), (9, 33), (16, 5), (37, 29)]


def _check_jpeg(data):
    got = jpeg.decode_jpeg(data)
    _same(got, _pil(data))
    _same(got, _cv2(data))
    lib, plain = jpeg.coefficients(data), jpeg.coefficients_plain(data)
    assert len(lib) == len(plain)
    for a, b in zip(lib, plain):
        assert (a["h"], a["v"]) == (b["h"], b["v"])
        _same_array(a["quant"], b["quant"])
        _same_array(a["coef"], b["coef"])


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("q", [75, 95])
def test_progressive_pil_files(sampling, q):
    for i, (h, w) in enumerate(SIZES):
        _check_jpeg(pil_progressive(golden_input(_seed(i, q), h, w), q,
                                    sampling))


@pytest.mark.parametrize("sampling", ["444", "422", "440", "420", "411"])
def test_progressive_cv2_files_with_restarts(sampling):
    for i, (h, w) in enumerate(SIZES):
        img = golden_input(_seed(i, sampling), h, w)
        for restart in (0, 1 + i % 3):
            _check_jpeg(cv2_progressive(img, 90, sampling, restart))


@pytest.mark.parametrize("writer", ["pil", "cv2"])
def test_progressive_grey(writer):
    for i, (h, w) in enumerate(SIZES):
        grey = np.ascontiguousarray(golden_input(i, h, w)[..., 1])
        _check_jpeg(pil_progressive(grey, 85) if writer == "pil"
                    else cv2_progressive(grey, 85, restart=i))


def test_baseline_coefficients_equal_the_plain_decoder():
    """The sequential scans through the Python decoder too: PIL's and
    cv2's baseline files, optimized tables and restarts."""
    img = golden_input(7, 37, 29)
    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", quality=90, optimize=True)
    files = [out.getvalue(), cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1].tobytes(),
        jpeg.encode_jpeg(img, 95)]
    for data in files:
        _check_jpeg(data)


def test_progressive_without_dc_refinement():
    """A file without its DC refinement scan keeps every AC coefficient
    whole: libjpeg does not smooth it, and its DC lacks the last bit in
    the port's decode as in PIL's and cv2's."""
    data = pil_progressive(golden_input(4, 37, 29), 90)
    head, scans = jpeg_scans(data)
    dc_refine = [i for i, s in enumerate(scans)
                 if s[5 + 2 * s[4]] == 0 and s[7 + 2 * s[4]] >> 4]
    assert len(dc_refine) == 1
    cut = head + b"".join(s for i, s in enumerate(scans)
                          if i != dc_refine[0]) + b"\xff\xd9"
    _check_jpeg(cut)
    assert not np.array_equal(jpeg.decode_jpeg(cut), jpeg.decode_jpeg(data))


def _dqt_tables(data):
    """(offset of the entries, Pq, Tq) of every table of every DQT."""
    out, at = [], 2
    while data[at + 1] != 0xDA:
        n = (data[at + 2] << 8) | data[at + 3]
        if data[at + 1] == 0xDB:
            p = at + 4
            while p < at + 2 + n:
                out.append((p + 1, data[p] >> 4, data[p] & 15))
                p += 1 + (128 if data[p] >> 4 else 64)
        at += 2 + n
    return out


def _raise_entry(data, table, k):
    """The file with entry k (zigzag order) of 8-bit table `table` at 255."""
    at = next(o for o, _, tq in _dqt_tables(data) if tq == table)
    return data[:at + k] + b"\xff" + data[at + k + 1:]


def _sixteen_bit_dqt(data, scale):
    """The file with every 8-bit table written as a 16-bit one (Pq = 1),
    its entries times `scale`."""
    tables = _dqt_tables(data)
    out, at = data[:2], 2
    while data[at + 1] != 0xDA:
        end = at + 2 + ((data[at + 2] << 8) | data[at + 3])
        seg = data[at:end]
        if data[at + 1] == 0xDB:
            body = b"".join(
                bytes([0x10 | tq]) + (np.frombuffer(data[o:o + 64], np.uint8)
                                      .astype(int) * scale).astype(">u2")
                .tobytes()
                for o, _, tq in tables if at < o < end)
            seg = b"\xff\xdb" + (len(body) + 2).to_bytes(2, "big") + body
        out += seg
        at = end
    return out + data[at:]


QUANT_CASES = ["luma DC", "luma AC1", "luma AC5", "luma AC63", "chroma DC",
               "chroma AC1", "16-bit", "16-bit x3", "16-bit x256", "grey DC"]


@pytest.mark.parametrize("case", QUANT_CASES)
@pytest.mark.parametrize("progressive", [False, True])
def test_unusual_quantization_tables(progressive, case):
    """Valid files with quantization tables the libraries' encoders do not
    write, at quality 50, 90 and 100 (4:2:0, or grey): one entry raised to
    255 after the fact (of the luma or chroma table, the DC or an AC), or
    every table as a 16-bit DQT (Pq = 1), as it was or times 3 or 256. Each
    decodes as PIL and cv2 decode it, bit for bit: libjpeg-turbo's x86-64
    SIMD IDCT, whose 16-bit lanes wrap and saturate where a raised entry
    takes the dequantized values past 16 bits (the DC cases do, which this
    test checks); jidctint.c's C arithmetic parts from both there."""
    widest = 0
    for q in (50, 90, 100):
        img = golden_input(_seed(case, q), 37, 29)
        if case.startswith("grey"):
            img = np.ascontiguousarray(img[..., 0])
        data = (pil_progressive(img, q) if progressive
                else pil_baseline(img, q))
        if case.startswith("16-bit"):
            data = _sixteen_bit_dqt(data, int(case.split("x")[1])
                                    if "x" in case else 1)
            assert {pq for _, pq, _ in _dqt_tables(data)} == {1}
        else:
            k = {"DC": 0, "AC1": 1, "AC5": 5, "AC63": 63}[case.split()[1]]
            data = _raise_entry(data, int(case.startswith("chroma")), k)
        _check_jpeg(data)
        widest = max(widest, *(int(np.abs(c["coef"].astype(np.int64)
                                          * c["quant"]).max())
                               for c in jpeg.coefficients(data)))
    if case.endswith(("DC", "x256")):
        assert widest > 32767, widest


def _sof10(data):
    at = next(i for i in range(len(data) - 1)
              if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC2))
    return data[:at + 1] + b"\xca" + data[at + 2:]


@pytest.mark.parametrize("case, match", [
    ("incomplete", "incomplete progressive JPEG: libjpeg would smooth it"),
    ("SOF10", r"arithmetic-coded JPEG \(SOF10, progressive\)"),
    ("truncated", "truncated data"),
    ("bad scan", "bad progressive scan parameters"),
])
def test_progressive_refusals(case, match):
    """What stays refused is refused by the library and the plain
    decoder with one message: a file cut after some of its scans (libjpeg
    would smooth it), SOF10, a file cut inside a scan, and a scan whose
    parameters libjpeg rejects."""
    data = pil_progressive(golden_input(3, 37, 29), 90)
    head, scans = jpeg_scans(data)
    if case == "incomplete":
        data = incomplete_progressive(data, 3)
    elif case == "SOF10":
        data = _sof10(data)
    elif case == "truncated":
        data = data[:len(data) - 200]
    else:   # an AC scan over two components
        data = head + scans[0] + b"\xff\xda" + bytes(
            [0, 10, 2, 1, 0x00, 2, 0x11, 1, 5, 0x20]) + b"\xff\xd9"
    messages = []
    for fn in (jpeg.decode_jpeg, jpeg.coefficients, jpeg.coefficients_plain):
        with pytest.raises(jpeg.JPEGError, match=match) as e:
            fn(data)
        messages.append(str(e.value))
    assert len(set(messages)) == 1, messages


# -- PNG: Adam7 and 16-bit ----------------------------------------------------

@pytest.mark.parametrize("color", sorted(DEPTHS))
@pytest.mark.parametrize("interlace", [0, 1])
def test_png_every_depth_against_pil_and_cv2(color, interlace):
    """Every colour type at every bit depth, Adam7 and not, at sizes that
    leave passes empty (1 x 1, one row, one column) and whole: PIL with
    `reader="pil"`, cv2 with `"cv2"`, and the library to the plain
    version."""
    for depth in DEPTHS[color]:
        for h, w in [(1, 1), (1, 9), (9, 1), (2, 3), (5, 5), (8, 8),
                     (13, 17), (33, 40)]:
            data = png_case(color, depth, h, w, interlace,
                            _seed(color, depth, h, w, interlace))
            for how, ref in (("pil", _pil(data)), ("cv2", _cv2(data))):
                got = image_io.decode_png(data, reader=how)
                _same(got, ref)
                _same(image_io.decode_png_plain(data, reader=how), got)


def test_sixteen_bit_semantics_differ_on_grey_only():
    """PIL clamps a 16-bit grey sample to 255; cv2 and PIL keep the high
    byte elsewhere. The table of `data/image_io.py`, measured."""
    rng = np.random.default_rng(0)
    for color in (0, 2, 4, 6):
        samples = rng.integers(0, 1 << 16, (4, 5, CHANNELS[color]))
        samples[0, 0] = 33375
        data = png_file(samples, 16, color)
        grey = samples[..., :1] if color in (0, 4) else samples[..., :3]
        high = np.broadcast_to(grey >> 8, (4, 5, 3)).astype(np.uint8)
        clamp = np.broadcast_to(np.minimum(grey, 255),
                                (4, 5, 3)).astype(np.uint8)
        _same(_cv2(data), high)
        _same(_pil(data), clamp if color == 0 else high)
        _same(image_io.decode_png(data, reader="cv2"), high)
        _same(image_io.decode_png(data, reader="pil"),
              clamp if color == 0 else high)
    assert int(_pil(png_file(samples[..., :1], 16, 0))[0, 0, 0]) == 255
    assert int(_cv2(png_file(samples[..., :1], 16, 0))[0, 0, 0]) == 130


def test_sixteen_bit_needs_the_argument(tmp_path):
    """A 16-bit file read without `reader` raises, naming it, in
    both versions and through `imread_rgb`; an 8-bit file needs none; a
    wrong value raises ValueError."""
    data = png_case(2, 16, 5, 4, 1, 0)
    for fn in (image_io.decode_png, image_io.decode_png_plain):
        with pytest.raises(image_io.PNGError, match="reader='cv2' or "
                           "'pil'"):
            fn(data)
        with pytest.raises(ValueError, match="reader must be one of"):
            fn(data, reader="PIL")
    (tmp_path / "a.png").write_bytes(data)
    with pytest.raises(image_io.PNGError, match="a.png: a 16-bit PNG"):
        image_io.imread_rgb(str(tmp_path / "a.png"))
    _same(image_io.imread_rgb(str(tmp_path / "a.png"), reader="pil"),
          _pil(data))
    _same(image_io.decode_png(png_case(2, 8, 5, 4, 1, 0)),
          _pil(png_case(2, 8, 5, 4, 1, 0)))


def test_interlaced_refusals():
    """A truncated interlaced stream and a bad filter inside a pass: one
    message from both versions, naming the pass."""
    data = png_case(6, 16, 13, 17, 1, 5)
    stream = zlib.decompress(_idat(data))
    raw_len = len(stream)
    short = _with_idat(data, zlib.compress(stream[:-1]))
    bad = bytearray(stream)
    first = (((17 + 7) // 8) * 8 + 1) * ((13 + 7) // 8)   # pass 1's bytes
    bad[first] = 7                                           # pass 2, row 0
    cases = [(short, rf"interlaced \(Adam7\) image data holds "
              rf"{raw_len - 1} bytes, {raw_len} wanted"),
             (_with_idat(data, zlib.compress(bytes(bad))),
              "pass 2 row 0: unknown filter type 7")]
    for blob, match in cases:
        messages = []
        for fn in (image_io.decode_png, image_io.decode_png_plain):
            with pytest.raises(image_io.PNGError, match=match) as e:
                fn(blob, reader="cv2")
            messages.append(str(e.value))
        assert messages[0] == messages[1]
        with pytest.raises(Exception):
            _pil(blob)


def _idat(data):
    out, pos = b"", 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            out += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return out


def _with_idat(data, stream):
    """The PNG `data` with its image data replaced by `stream`."""
    import struct

    head = data[:33]
    chunk = (struct.pack(">I", len(stream)) + b"IDAT" + stream
             + struct.pack(">I", zlib.crc32(b"IDAT" + stream)))
    return head + chunk + data[-12:]


# -- BMP ----------------------------------------------------------------------

def bmp_case(kind, h, w, seed):
    """A seeded BMP (bmp_file) of one variant: `kind` is
    "<header>-<bits>[-<how>]" with how one of topdown, bw (a black-and-white
    1-bit palette), grey (PIL's grey ramp as palette), short (a palette of
    fewer entries than the bits allow), rle, 555 / 565 / BGRA / RGBA /
    XBGR (BI_BITFIELDS)."""
    header, bits, *how = kind.split("-")
    header, bits, how = int(header), int(bits), (how or [""])[0]
    rng = np.random.default_rng(seed)
    if bits <= 8:
        colors = 5 if how == "short" else 1 << bits
        palette = rng.integers(0, 256, (colors, 3))
        if how == "bw":
            palette = np.array([[0, 0, 0], [255, 255, 255]])
        if how == "grey":
            palette = np.repeat(np.arange(colors)[:, None], 3, 1)
        y, x = np.mgrid[:h, :w]
        pixels = ((x // 3 + y // 2) % colors + (rng.uniform(size=(h, w))
                                                < 0.3)) % colors
        if how == "short":   # indices past the palette read black
            pixels[0, 0] = (1 << bits) - 1
        return bmp_file(pixels, bits, header, palette=palette,
                           rle=how == "rle")
    rgb = golden_input(seed, h, w)
    fields = how if how in ("555", "565", "BGRA", "RGBA", "XBGR") else None
    return bmp_file(rgb, bits, header, topdown=how == "topdown",
                       fields=fields)


BMP_KINDS = ["12-1", "12-4", "12-8", "12-24", "40-1", "40-1-bw", "40-4",
             "40-4-grey", "40-4-rle", "40-8", "40-8-grey", "40-8-short",
             "40-8-rle", "40-16", "40-16-565", "40-16-555", "40-24",
             "40-24-topdown", "40-32", "40-32-BGRA", "40-32-XBGR",
             "56-32-RGBA",
             "108-24", "108-16-565", "124-32-BGRA", "124-8", "124-24-topdown"]


def _check_bmp(data):
    """The file decoded as PIL decodes it by both versions, or, where PIL
    raises, refused by both with one message. Returns whether it
    decoded."""
    try:
        want = _pil(data)
    except Exception:
        messages = []
        for fn in (image_io.decode_bmp, image_io.decode_bmp_plain):
            with pytest.raises(image_io.BMPError) as e:
                fn(data)
            messages.append(str(e.value))
        assert messages[0] == messages[1]
        return False
    got = image_io.decode_bmp(data)
    _same(got, want)
    _same(image_io.decode_bmp_plain(data), got)
    return True


@pytest.mark.parametrize("kind", BMP_KINDS)
def test_bmp_variants_against_pil(kind):
    """Each variant at five sizes. PIL reads a 4-bit file of its grey ramp
    a byte a pixel, and refuses it where a row's pixels would run past the
    row's stored bytes (wider than 4): the port refuses it there too."""
    decoded = [_check_bmp(bmp_case(kind, h, w, _seed(kind, h, w)))
               for h, w in [(1, 1), (3, 4), (7, 13), (16, 9), (33, 17)]]
    assert all(decoded) or (kind == "40-4-grey" and decoded[:2] == [True,
                                                                    True])


def test_bmp_rle_streams_against_pil():
    """Seeded RLE8 / RLE4 streams of every escape (runs past the row's
    end, end of line, delta, absolute runs of odd counts, end of bitmap,
    streams that stop early) decode as PIL's BmpRleDecoder decodes them,
    or are refused where PIL raises, one message from both versions."""
    decoded = refused = 0
    for seed in range(300):
        rng = np.random.default_rng(seed)
        h, w = int(rng.integers(1, 9)), int(rng.integers(1, 24))
        rle4 = bool(seed % 2)
        body = bytearray()
        for _ in range(int(rng.integers(1, 40))):
            k = rng.uniform()
            if k < 0.45:
                body += bytes([int(rng.integers(1, 20)),
                               int(rng.integers(0, 256))])
            elif k < 0.6:
                body += b"\0\0"
            elif k < 0.67:
                body += bytes([0, 2, *rng.integers(0, 4, 4).tolist()])
            elif k < 0.69:
                body += b"\0\1"
            else:
                n = int(rng.integers(3, 14))
                body += bytes([0, n]) + bytes(rng.integers(0, 256, n)
                                              .astype(np.uint8))
        data = bmp_file(np.zeros((h, w), int), 4 if rle4 else 8, 40,
                           palette=rng.integers(0, 256, (16, 3)), rle=True)
        offset = int.from_bytes(data[10:14], "little")
        data = data[:offset] + bytes(body)
        try:
            want = _pil(data)
        except Exception:   # PIL raises: so must both versions
            messages = []
            for fn in (image_io.decode_bmp, image_io.decode_bmp_plain):
                with pytest.raises(image_io.BMPError) as e:
                    fn(data)
                messages.append(str(e.value))
            assert messages[0] == messages[1]
            refused += 1
            continue
        _same(image_io.decode_bmp(data), want)
        _same(image_io.decode_bmp_plain(data), want)
        decoded += 1
    assert decoded > 50 and refused > 50, (decoded, refused)


# A 10,000,000 x 1 RLE8 BMP of one delta escape of 255 columns and 255
# rows (PIL's delta reads four bytes and moves by the last two), then end of
# bitmap, decoded by both versions in a process whose address space may grow
# by 1 GiB: the delta asks for 2.55 GB of indices.
RLE_DELTA = """
import resource, sys
import numpy as np
from hifidiff_tpu_torch.data import host, image_io
from hifidiff_tpu_torch.data.image_files import bmp_file
w = 10_000_000
data = bmp_file(np.zeros((1, 1), int), 8, palette=[[7, 8, 9]] * 256, rle=True)
offset = int.from_bytes(data[10:14], "little")
data = (data[:18] + w.to_bytes(4, "little") + data[22:offset]
        + bytes([0, 2, 0, 0, 255, 255, 0, 1]))
host.library()
vm = next(int(ln.split()[1]) for ln in open("/proc/self/status")
          if ln.startswith("VmSize:")) * 1024
resource.setrlimit(resource.RLIMIT_AS, (vm + (1 << 30), vm + (1 << 30)))
for fn in (image_io.decode_bmp, image_io.decode_bmp_plain):
    out = fn(data)
    assert out.shape == (1, w, 3) and (out == [7, 8, 9]).all(), fn.__name__
print("ok")
"""


def test_bmp_rle_delta_stops_at_the_image_end():
    """A delta escape moves by up to 255 columns and 255 rows of the
    image's width, read from the file: PIL grows its index buffer by all
    of it, though the decoder stops at the image's end and cuts the buffer
    there. Both versions stop the growth at the end (the same pixels), so
    a 10,000,000 x 1 file of about 1 kB decodes within 1 GiB more address
    space, where the delta alone would ask for 2.55 GB."""
    res = subprocess.run([sys.executable, "-c", RLE_DELTA], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.split() == ["ok"], res.stderr


def test_host_library_returns_no_memory():
    """An allocation that fails inside the host library comes back as
    `host.NO_MEMORY` rather than as a C++ exception through ctypes, which
    would abort the process: an RLE BMP and a filter2d of 2^30 x 2^30,
    whose buffers (2^60 bytes, 2^60 doubles) are made before any pixel is
    read or written."""
    lib = host.library()
    out = np.zeros(3, np.uint8)
    pal = np.zeros((1, 3), np.uint8)
    detail = (ctypes.c_int * 2)()
    assert lib.hi_bmp_rgb(b"\0\1", 2, 0, 1 << 30, 1 << 30, 0, 0, 8, 2, 1,
                          0, pal.ctypes.data, 1, 1, out.ctypes.data,
                          detail) == host.NO_MEMORY
    img = np.zeros(1, np.float32)
    kernel = np.ones(1)
    assert lib.hi_filter2d(img.ctypes.data, img.ctypes.data, 1 << 30,
                           1 << 30, 1, kernel.ctypes.data, 1,
                           1) == host.NO_MEMORY


@pytest.mark.parametrize("case, match", [
    ("header", "unsupported BMP header size 20"),
    ("bits", "unsupported BMP bit depth 2"),
    ("fields", "unsupported BMP bitfields layout"),
    ("jpeg", r"unsupported BMP compression 4 \(JPEG inside a BMP\)"),
    ("truncated", "truncated BMP pixel data"),
    ("empty", "an empty BMP"),
])
def test_bmp_refusals(case, match):
    data = bytearray(bmp_case("40-24", 6, 7, 1))
    if case == "header":
        data[14] = 20
    elif case == "bits":
        data[28] = 2
    elif case == "fields":
        data = bytearray(bmp_case("40-16-565", 6, 7, 1))
        data[54:58] = (0xF00).to_bytes(4, "little")
    elif case == "jpeg":
        data[30] = 4
    elif case == "truncated":
        data = data[:-5]
    else:
        data[18:22] = bytes(4)
    messages = []
    for fn in (image_io.decode_bmp, image_io.decode_bmp_plain):
        with pytest.raises(image_io.BMPError, match=match) as e:
            fn(bytes(data))
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    with pytest.raises(Exception):
        _pil(bytes(data))


# -- by signature -------------------------------------------------------------

def test_imread_rgb_reads_every_format_and_names_the_rest(tmp_path):
    """`imread_rgb` and `decode_image` read PNG, JPEG, WebP and BMP by
    their signature; a GIF or anything else raises `ImageFormatError` (a
    ValueError, which the datasets' loader and the server's 400 both take),
    naming the formats the port reads (a TIFF file named as one). An animated WebP reads as its first
    frame and a CMYK JPEG as the reader named reads it; the CMYK file
    without a reader raises `JPEGError` and a truncated animation
    `WebPError` (each a ValueError too), naming the cause."""
    img = golden_input(2, 21, 19)
    still, lossy, animated = io.BytesIO(), io.BytesIO(), io.BytesIO()
    Image.fromarray(img).save(still, "WEBP", lossless=True)
    Image.fromarray(img).save(lossy, "WEBP", quality=80)
    Image.fromarray(img).save(animated, "WEBP", lossless=True, save_all=True,
                              append_images=[Image.fromarray(img[::-1])])
    files = {"a.png": png_case(2, 16, 21, 19, 1, 3),
             "b.jpg": pil_progressive(img, 90),
             "c.bmp": bmp_file(img, 24),
             "d.dat": bmp_file(img, 24),     # the name does not matter
             "e.webp": still.getvalue(),
             "e2.webp": lossy.getvalue()}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        _same(image_io.imread_rgb(str(tmp_path / name), reader="pil"),
              _pil(data))
        _same(image_io.decode_image(data, reader="pil"), _pil(data))
    gif, tiff = io.BytesIO(), io.BytesIO()
    Image.fromarray(img).save(gif, "GIF")
    Image.fromarray(img).save(tiff, "TIFF")
    for name, data, what in (("f.gif", gif.getvalue(), "a GIF file"),
                             ("f2.tif", tiff.getvalue(), "a TIFF file"),
                             ("g.png", b"not an image",
                              "not an image the port knows")):
        (tmp_path / name).write_bytes(data)
        with pytest.raises(image_io.ImageFormatError,
                           match=f"{name}: {what}: the port reads PNG, JPEG "
                           r"\(baseline, extended and progressive\), WebP "
                           "and BMP") as e:
            image_io.imread_rgb(str(tmp_path / name))
        assert isinstance(e.value, ValueError)
        assert not isinstance(e.value, (image_io.PNGError, jpeg.JPEGError))
    cmyk = pil_cmyk(img, 90)
    for name, data in (("h.webp", animated.getvalue()), ("i.jpg", cmyk)):
        (tmp_path / name).write_bytes(data)
        for how, ref in (("pil", _pil), ("cv2", _cv2)):
            _same(image_io.imread_rgb(str(tmp_path / name), reader=how),
                  ref(data))
    assert not np.array_equal(_pil(cmyk), _cv2(cmyk))
    (tmp_path / "j.webp").write_bytes(animated.getvalue()[:-9])
    for name, error, what in (
            ("i.jpg", jpeg.JPEGError, "a CMYK JPEG: pass reader='cv2' or "
             "'pil'"), ("j.webp", webp.WebPError, "truncated")):
        with pytest.raises(error, match=f"{name}: {what}") as e:
            image_io.imread_rgb(str(tmp_path / name))
        assert isinstance(e.value, ValueError)


def test_phase15_celeba_files_read_as_pil_reads_them():
    """chip_smoke.py's CelebA-HQ directory (phase 15, read by
    `pretrain_denoiser --celeba-root` there) holds every format in turn:
    each of its sixteen kinds decodes as PIL decodes it, the library equal
    to the plain version (the lossy WebP's coefficients to the plain
    parse's, the CMYK JPEG's colour steps to the plain ones)."""
    from hifidiff_tpu_torch.data import procedural as proc

    face = (proc.render_face(proc._identity_params(0, 1), 0.1, 64)
            * 255).astype(np.uint8)
    progressive = (FIXTURES / "jpeg" / CELEBA_PROGRESSIVE).read_bytes()
    webps = [(FIXTURES / "webp" / n).read_bytes() for n in CELEBA_WEBP]
    cmyk = (FIXTURES / "jpeg" / CELEBA_CMYK).read_bytes()
    kinds = set()
    for j in range(16):
        data, ext = celeba_file(face, j, progressive, webps, cmyk)
        kinds.add((ext, data[24] if ext == ".png" else None,
                   data[28] if ext == ".png" else data[30]))
        got = image_io.decode_image(data, reader="pil")
        _same(got, _pil(data))
        if ext == ".png":
            _same(image_io.decode_png_plain(data, reader="pil"), got)
        elif ext == ".bmp":
            _same(image_io.decode_bmp_plain(data), got)
        elif ext == ".webp" and webp.parse(data).lossless:
            _same(webp.decode_webp_plain(data), got)
        elif ext == ".webp":
            for a, b in zip(webp.vp8_coefficients(data),
                            webp.vp8_coefficients_plain(data)):
                _same_array(a, b)
        elif data == cmyk:
            _same(jpeg.cmyk_to_rgb_plain(jpeg.components(data)[0], "pil"),
                  got)
    assert webp.parse(webps[2]).canvas is not None
    assert {(e, d) for e, d, _ in kinds} == {
        (".png", 8), (".png", 16), (".jpg", None), (".bmp", None),
        (".webp", None)}
    assert {(d, lace) for e, d, lace in kinds if e == ".png"} == {
        (8, 0), (8, 1), (16, 0), (16, 1)}
    assert {c for e, _, c in kinds if e == ".bmp"} == {0, 1}   # RLE8 too


# -- golden fixtures ----------------------------------------------------------

def jpeg_fixtures():
    """{name: bytes} of the progressive JPEG fixtures, written by PIL and
    cv2 from seeded inputs, and the JPEG refusals added with them."""
    from hifidiff_tpu_torch.data import procedural as proc

    face = (proc.render_face(proc._identity_params(0, 3), 0.2, 160)
            * 255).astype(np.uint8)
    frame = proc.render_face(proc._identity_params(0, 0), 0.3, 640)
    frame = (np.tile(frame, (2, 3, 1))[:1080, :1920] * 255).astype(np.uint8)
    g = golden_input
    out = {
        "pil_prog_420_q90_37x29.jpg": pil_progressive(g(21, 37, 29), 90),
        "pil_prog_444_q95_21x33.jpg": pil_progressive(g(22, 21, 33), 95,
                                                      "444"),
        "pil_prog_grey_q85_29x45.jpg": pil_progressive(
            np.ascontiguousarray(g(23, 29, 45)[..., 0]), 85),
        "cv2_prog_420_q90_rst2_45x37.jpg": cv2_progressive(
            g(24, 45, 37), 90, "420", 2),
        "cv2_prog_444_q85_rst1_33x21.jpg": cv2_progressive(
            g(25, 33, 21), 85, "444", 1),
        "cv2_prog_grey_q90_rst3_23x41.jpg": cv2_progressive(
            np.ascontiguousarray(g(26, 23, 41)[..., 2]), 90, restart=3),
        "pil_prog_face_q95_160x160.jpg": pil_progressive(face, 95),
        "pil_prog_frame_q95_1920x1080.jpg": pil_progressive(frame, 95),
    }
    # quantization tables raised after the fact: the SIMD IDCT's 16-bit
    # lanes wrap and saturate on them (test_unusual_quantization_tables)
    out["pil_dc255_420_q90_37x29.jpg"] = _raise_entry(pil_baseline(
        g(27, 37, 29), 90), 0, 0)
    out["pil_prog_dqt16x256_420_q90_37x29.jpg"] = _sixteen_bit_dqt(
        pil_progressive(g(28, 37, 29), 90), 256)
    out["prog_incomplete_37x29.jpg"] = incomplete_progressive(
        out["pil_prog_420_q90_37x29.jpg"], 4)
    out["prog_sof10_37x29.jpg"] = _sof10(out["pil_prog_420_q90_37x29.jpg"])
    out.update(four_component_fixtures(face))
    return out


def four_component_fixtures(face):
    """{name: bytes}: PIL's CMYK files at 4:4:4, 4:2:0 and 4:2:2, a
    progressive one and the 160 x 160 face; one without its Adobe marker
    (CMYK all the same); YCCK files (`jpeg_adobe_transform` of PIL's, at
    4:4:4 and progressive 4:2:0); PIL's RGB-coded file and one without its
    Adobe marker (read as RGB by its component ids)."""
    g = golden_input
    out = {"pil_cmyk_444_q90_37x29.jpg": pil_cmyk(g(29, 37, 29), 90),
           "pil_cmyk_420_q90_37x29.jpg": pil_cmyk(g(30, 37, 29), 90, "420"),
           "pil_cmyk_422_q85_29x37.jpg": pil_cmyk(g(31, 29, 37), 85, "422"),
           "pil_cmyk_prog_420_q90_37x29.jpg": pil_cmyk(g(32, 37, 29), 90,
                                                       "420", True),
           "pil_cmyk_face_q90_160x160.jpg": pil_cmyk(face, 90, "420"),
           "pil_rgb_keep_q90_37x29.jpg": pil_rgb_coded(g(33, 37, 29), 90)}
    out["cmyk_no_adobe_420_q90_37x29.jpg"] = jpeg_without_adobe(
        out["pil_cmyk_420_q90_37x29.jpg"])
    out["ycck_444_q90_37x29.jpg"] = jpeg_adobe_transform(
        out["pil_cmyk_444_q90_37x29.jpg"], 2)
    out["ycck_prog_420_q90_37x29.jpg"] = jpeg_adobe_transform(
        out["pil_cmyk_prog_420_q90_37x29.jpg"], 2)
    out["rgb_ids_no_adobe_q90_37x29.jpg"] = jpeg_without_adobe(
        out["pil_rgb_keep_q90_37x29.jpg"])
    return out


def four_components(data):
    """Whether a JPEG file's frame has four components (CMYK or YCCK),
    whose RGB depends on the reader."""
    return jpeg.components(data)[1] in ("cmyk", "ycck")


JPEG_REFUSE = {"prog_incomplete_37x29.jpg": "incomplete progressive JPEG",
               "prog_sof10_37x29.jpg": "arithmetic-coded JPEG"}


def png_fixtures():
    """{name: bytes}: Adam7 at every colour type and bit depth, and 16-bit
    non-interlaced files of colour types 0, 2, 4 and 6, seeded."""
    out = {}
    for color, depths in DEPTHS.items():
        for depth in depths:
            h, w = 9 + 2 * color + depth % 5, 11 + color + depth % 7
            out[f"adam7_c{color}_d{depth}_{h}x{w}.png"] = png_case(
                color, depth, h, w, 1, _seed("adam7", color, depth))
    for color in (0, 2, 4, 6):
        out[f"png16_c{color}_15x13.png"] = png_case(
            color, 16, 15, 13, 0, _seed("png16", color))
    data = out["adam7_c6_d16_22x19.png"]
    stream = zlib.decompress(_idat(data))
    out["adam7_truncated_22x19.png"] = _with_idat(
        data, zlib.compress(stream[:-40]))
    return out


PNG_REFUSE = {"adam7_truncated_22x19.png": r"interlaced \(Adam7\) image "
              "data holds"}


def bmp_fixtures():
    """{name: bytes}: every BMP variant the decoder takes, seeded, and a
    refusal."""
    out = {}
    for kind in BMP_KINDS:
        w = 4 if kind == "40-4-grey" else 11   # PIL's widest for that one
        out[f"bmp_{kind}_13x{w}.bmp"] = bmp_case(kind, 13, w,
                                                  _seed("bmp", kind))
    bad = bytearray(out["bmp_40-16-565_13x11.bmp"])
    bad[54:58] = (0xF00).to_bytes(4, "little")
    out["bmp_fields_refused_13x11.bmp"] = bytes(bad)
    return out


BMP_REFUSE = {"bmp_fields_refused_13x11.bmp":
              "unsupported BMP bitfields layout"}


def _digests(files, refuse, semantics):
    out = {"source": "PIL 12.1.0 and cv2 5.0.0: each file decoded as the "
                     "named library decodes it, RGB uint8",
           "decode": {}, "refuse": refuse}
    for name, data in sorted(files.items()):
        if name in refuse:
            continue
        out["decode"][name] = {how: {"shape": list(rgb.shape),
                                     "sha256": _sha(rgb)}
                               for how, rgb in semantics(data).items()}
    return out


def _png_semantics(data):
    return {"pil": _pil(data), "cv2": _cv2(data)}


def _bmp_semantics(data):
    return {"pil": _pil(data)}


def write_fixtures():
    """Writes the fixtures and the PNG, BMP and orientation digests; adds
    the progressive JPEG files to tests/fixtures/jpeg/digests.json."""
    d = FIXTURES / "orientation"
    d.mkdir(exist_ok=True)
    files = orientation_fixtures()
    for name, data in files.items():
        (d / name).write_bytes(data)
    (d / "digests.json").write_text(json.dumps(
        _orientation_digests(files, d), indent=1) + "\n")
    for sub, files in (("png", png_fixtures()), ("bmp", bmp_fixtures())):
        d = FIXTURES / sub
        d.mkdir(exist_ok=True)
        for name, data in files.items():
            (d / name).write_bytes(data)
        refuse, sem = ((PNG_REFUSE, _png_semantics) if sub == "png"
                       else (BMP_REFUSE, _bmp_semantics))
        (d / "digests.json").write_text(json.dumps(
            _digests(files, refuse, sem), indent=1) + "\n")
    golden_path = FIXTURES / "jpeg" / "digests.json"
    golden = json.loads(golden_path.read_text())
    golden["source"] = ("cv2 5.0.0 and Pillow 12.1.0, both on libjpeg-turbo "
                        "3.1.2; 'decode_by_reader': the four-component "
                        "files, whose RGB each library makes in its own way")
    by_reader = golden.setdefault("decode_by_reader", {})
    cmyk = "pil_cmyk_16x16.jpg"
    golden["refuse"].pop(cmyk, None)
    files = {cmyk: (FIXTURES / "jpeg" / cmyk).read_bytes(), **jpeg_fixtures()}
    for name, data in files.items():
        (FIXTURES / "jpeg" / name).write_bytes(data)
        if name in JPEG_REFUSE:
            golden["refuse"][name] = JPEG_REFUSE[name]
        elif four_components(data):
            by_reader[name] = {how: {"shape": list(rgb.shape),
                                     "sha256": _sha(rgb)}
                               for how, rgb in (("pil", _pil(data)),
                                                ("cv2", _cv2(data)))}
        else:
            rgb = _pil(data)
            golden["decode"][name] = {"shape": list(rgb.shape),
                                      "sha256": _sha(rgb)}
    progressive = "pil_progressive_32x32.jpg"
    golden["refuse"].pop(progressive, None)
    rgb = _pil((FIXTURES / "jpeg" / progressive).read_bytes())
    golden["decode"][progressive] = {"shape": list(rgb.shape),
                                     "sha256": _sha(rgb)}
    golden_path.write_text(json.dumps(golden, indent=1) + "\n")


@pytest.mark.parametrize("sub", ["png", "bmp"])
def test_png_and_bmp_fixtures_rebuilt(sub):
    """The committed PNG and BMP fixtures are `data/image_files.py`'s writers'
    bytes for their seeds, and digests.json holds PIL's (and, for PNG,
    cv2's) decodes of them; the port gives the same digests and refuses
    the refused files; the library and the plain versions agree."""
    files = png_fixtures() if sub == "png" else bmp_fixtures()
    d = FIXTURES / sub
    golden = json.loads((d / "digests.json").read_text())
    assert sorted(p.name for p in d.iterdir()) == sorted(
        [*files, "digests.json"])
    assert sum(p.stat().st_size for p in d.iterdir()) < 100_000
    for name, data in files.items():
        assert (d / name).read_bytes() == data, name
    sem = _png_semantics if sub == "png" else _bmp_semantics
    assert golden == json.loads(json.dumps(_digests(
        files, PNG_REFUSE if sub == "png" else BMP_REFUSE, sem)))
    for name, by_how in golden["decode"].items():
        data = files[name]
        for how, want in by_how.items():
            if sub == "png":
                got = image_io.decode_png(data, reader=how)
                plain = image_io.decode_png_plain(data, reader=how)
            else:
                got = image_io.decode_bmp(data)
                plain = image_io.decode_bmp_plain(data)
            assert [list(got.shape), _sha(got)] == [want["shape"],
                                                    want["sha256"]], name
            _same(plain, got)
    error = image_io.PNGError if sub == "png" else image_io.BMPError
    for name, match in golden["refuse"].items():
        with pytest.raises(error, match=match):
            image_io.decode_image(files[name], reader="cv2")
        with pytest.raises(Exception):
            _pil(files[name])
    kinds = {n.split("_")[1] for n in golden["decode"]}
    if sub == "png":
        assert {f"c{c}" for c in DEPTHS} <= kinds | {
            n.split("_")[1] for n in golden["decode"] if "png16" in n}
        assert all(f"adam7_c{c}_d{d}_" in " ".join(golden["decode"])
                   for c in DEPTHS for d in DEPTHS[c])


def test_progressive_jpeg_fixtures_rebuilt():
    """The progressive, four-component and RGB-coded fixtures of
    tests/fixtures/jpeg are PIL's and cv2's files for their seeds (and
    `data/image_files.py`'s re-labellings of them), in digests.json with
    PIL's and cv2's decodes, per reader for the four-component ones
    (test_torch_jpeg.py's golden test holds every entry), and the
    library's coefficients of each equal the plain decoder's."""
    golden = json.loads((FIXTURES / "jpeg" / "digests.json").read_text())
    files = jpeg_fixtures()
    for name, data in files.items():
        assert (FIXTURES / "jpeg" / name).read_bytes() == data, name
        if name in JPEG_REFUSE:
            assert golden["refuse"][name] == JPEG_REFUSE[name]
            continue
        assert name in (golden["decode_by_reader"] if four_components(data)
                        else golden["decode"]), name
        if "1920x1080" not in name:   # the frame: about 4 s plain
            lib, plain = jpeg.coefficients(data), jpeg.coefficients_plain(
                data)
            for a, b in zip(lib, plain):
                _same_array(a["coef"], b["coef"])
    assert "pil_progressive_32x32.jpg" in golden["decode"]


# -- EXIF orientation ---------------------------------------------------------

def _tiff(orientation, mm=False, kind=3, extra=()):
    """A TIFF block of an IFD0 holding a Make string and the Orientation
    tag (of TIFF type `kind`), then the `extra` (tag, type, count, value)
    entries."""
    import struct

    e = ">" if mm else "<"
    value = (struct.pack(e + "HH", orientation, 0) if kind == 3
             else struct.pack(e + "I", orientation))
    entries = [struct.pack(e + "HHI", 0x10F, 2, 4) + b"abc\0",
               struct.pack(e + "HHI", 0x112, kind, 1) + value]
    entries += [struct.pack(e + "HHII", *x) for x in extra]
    return ((b"MM" if mm else b"II") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", len(entries)) + b"".join(entries)
            + b"\0\0\0\0")


def _png_with(data, before=(), after=()):
    """A PNG with eXIf chunks of `before` ahead of its IDAT and of `after`
    behind it."""
    import struct

    def chunk(body):
        return (struct.pack(">I", len(body)) + b"eXIf" + body
                + struct.pack(">I", zlib.crc32(b"eXIf" + body)))
    idat = data.index(b"IDAT") - 4
    iend = len(data) - 12
    return (data[:idat] + b"".join(map(chunk, before)) + data[idat:iend]
            + b"".join(map(chunk, after)) + data[iend:])


def _jpeg_with(data, app1s=(), after_dqt=False):
    """A JPEG with the APP1 segments `app1s` after SOI (or before its
    first DQT)."""
    import struct

    segs = b"".join(b"\xff\xe1" + struct.pack(">H", len(p) + 2) + p
                    for p in app1s)
    at = data.index(b"\xff\xdb") if after_dqt else 2
    return data[:at] + segs + data[at:]


def _webp_with(img, blocks=(), flags=0x08, before=False):
    """A lossless extended WebP with the EXIF chunks `blocks` after (or
    before) its image chunk."""
    import struct

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", lossless=True)
    image = buf.getvalue()[12:]
    h, w = img.shape[:2]
    exif = b"".join(b"EXIF" + struct.pack("<I", len(b)) + b
                    + b"\0" * (len(b) & 1) for b in blocks)
    body = (b"WEBP" + b"VP8X" + struct.pack("<I", 10)
            + bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
            + (h - 1).to_bytes(3, "little")
            + (exif + image if before else image + exif))
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _oriented(fmt, blocks, img=None):
    """A file of `fmt` ("png", "jpg", "webp") carrying the EXIF blocks."""
    img = golden_input(81, 5, 7) if img is None else img
    if fmt == "png":
        return _png_with(png_filtered(img), blocks)
    if fmt == "jpg":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=95)
        return _jpeg_with(buf.getvalue(), [b"Exif\0\0" + b for b in blocks])
    return _webp_with(img, blocks)


def _imread_both(tmp_path, name, data):
    """(the port's reading with reader="cv2", cv2.imread's in RGB)."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path))[..., ::-1]
    return image_io.imread_rgb(str(path), reader="cv2"), want


@pytest.mark.parametrize("fmt", ["png", "jpg", "webp"])
def test_exif_orientation_as_cv2_imread(tmp_path, fmt):
    """Orientations 0-9 of a 7 x 5 file: `reader="cv2"` gives
    `cv2.imread` (2-8 flipped and transposed, 5-8 5 wide and 7 high),
    "pil" and no reader give PIL's unrotated image."""
    for o in range(10):
        data = _oriented(fmt, [_tiff(o)])
        got, want = _imread_both(tmp_path, f"o{o}.{fmt}", data)
        _same(got, want)
        assert got.shape[:2] == ((7, 5) if 5 <= o <= 8 else (5, 7))
        _same(image_io.decode_image(data, reader="cv2"), want)
        _same(image_io.decode_image(data, reader="pil"), _pil(data))
        _same(image_io.decode_image(data), _pil(data))


def _edge_cases():
    """{name: file bytes}: where cv2 reads an orientation and where it does
    not, measured with cv2 5.0."""
    import struct

    t6, t3 = _tiff(6), _tiff(3)
    bad_magic = b"II\x2b\0" + t6[4:]
    no_orient = t6[:8] + b"\1\0" + t6[10:22] + b"\0" * 4
    img = golden_input(82, 5, 7)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=95)
    jpg, png = buf.getvalue(), png_filtered(img)
    out = {
        "png after IDAT": _png_with(png, after=[t6]),
        "png two eXIf": _png_with(png, [t6, t3]),
        "png before and after": _png_with(png, [t6], [t3]),
        "png invalid, then one": _png_with(png, [bad_magic, t3]),
        "png short, then one": _png_with(png, [b"II*", t3]),
        "png without, then one": _png_with(png, [no_orient, t3]),
        "png MM": _png_with(png, [_tiff(8, mm=True)]),
        "png LONG": _png_with(png, [_tiff(6, kind=4)]),
        "png MM LONG": _png_with(png, [_tiff(6, mm=True, kind=4)]),
        "png loop": _png_with(png, [t6[:-4] + b"\x08\0\0\0"]),
        "png IFD past the end": _png_with(png, [t6[:4] + b"\xe8\3\0\0"
                                                + t6[8:]]),
        "png Exif prefix": _png_with(png, [b"Exif\0\0" + t6]),
        "jpg two APP1": _jpeg_with(jpg, [b"Exif\0\0" + t6,
                                         b"Exif\0\0" + t3]),
        "jpg invalid, then one": _jpeg_with(jpg, [b"Exif\0\0" + bad_magic,
                                                  b"Exif\0\0" + t3]),
        "jpg without, then one": _jpeg_with(jpg, [b"Exif\0\0" + no_orient,
                                                  b"Exif\0\0" + t3]),
        "jpg XMP, then Exif": _jpeg_with(jpg, [b"http://ns.adobe.com/xap/1.0/"
                                               b"\0<x/>", b"Exif\0\0" + t6]),
        "jpg after DQT": _jpeg_with(jpg, [b"Exif\0\0" + t6], after_dqt=True),
        "jpg Exif and one NUL": _jpeg_with(jpg, [b"Exif\0" + t6]),
        "jpg IM": _jpeg_with(jpg, [b"Exif\0\0IM" + _tiff(6, mm=True)[2:]]),
        "jpg II, big-endian magic": _jpeg_with(jpg, [b"Exif\0\0II\0*"
                                                     + t6[4:]]),
        "webp two EXIF": _webp_with(img, [t6, t3]),
        "webp invalid, then one": _webp_with(img, [bad_magic, t3]),
        "webp no EXIF flag": _webp_with(img, [t6], flags=0),
        "webp before the image": _webp_with(img, [t6], before=True),
        "webp Exif prefix": _webp_with(img, [b"Exif\0\0" + t6]),
    }
    for n in range(29, 38):      # the IFD cut inside the orientation entry
        out[f"png cut to {n}"] = _png_with(png, [t6[:n]])
        out[f"jpg cut to {n}"] = _jpeg_with(jpg, [b"Exif\0\0" + t6[:n]])
    for tag in (0x10E, 0x10F, 0x11A, 0x13E, 0x13F, 0x211, 0x213, 0x214,
                0x8769):         # read before the orientation entry
        for offset in (30, 1000):
            entry = struct.pack("<HHII", tag, 5 if tag != 0x10F else 2, 7,
                                offset)
            out[f"png tag {tag:#x} at {offset}"] = _png_with(
                png, [t6[:8] + b"\2\0" + entry + t6[22:]])
    return out


def test_exif_orientation_edges_as_cv2_imread(tmp_path):
    """Each edge case cv2 was measured at, against `cv2.imread`: the first
    eXIf chunk libpng keeps (after IDAT too), every Exif APP1 in turn, the
    first WebP EXIF chunk under the VP8X flag, the value's bytes wherever
    the IFD is cut, tags whose data past the end stops the walk."""
    rotated = 0
    for k, (name, data) in enumerate(_edge_cases().items()):
        ext = name.split()[0]
        got, want = _imread_both(tmp_path, f"e{k}.{ext}", data)
        _same(got, want)
        rotated += got.shape[0] == 7 or not np.array_equal(
            got, image_io.decode_image(data))
    assert 20 < rotated < len(_edge_cases()), rotated


def test_exif_orientation_random_blocks_as_cv2_imread(tmp_path):
    """200 seeded EXIF blocks of random entries (cv2's string and rational
    tags among them, offsets and counts in and past the data, cuts, both
    byte orders) in PNG and JPEG files: the orientation cv2 applies."""
    import struct

    rng = np.random.default_rng(86)
    tags = (0x10E, 0x10F, 0x110, 0x112, 0x11A, 0x11B, 0x128, 0x131, 0x13E,
            0x13F, 0x211, 0x213, 0x214, 0x8298, 0x8769, 0x100, 0x112)
    img = golden_input(83, 5, 7)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=95)
    jpg, png = buf.getvalue(), png_filtered(img)
    differ = 0
    for k in range(200):
        e = ">" if rng.random() < 0.3 else "<"
        n = int(rng.integers(1, 6))
        entries = b""
        for _ in range(n):
            tag = int(rng.choice(tags))
            count = int(rng.choice([1, 2, 4, 5, 9, 40]))
            value = int(rng.integers(0, 120)) if rng.random() < 0.8 else int(
                rng.integers(1, 9))
            entries += struct.pack(e + "HHII", tag, int(rng.integers(1, 6)),
                                   count, value)
            if tag == 0x112 and rng.random() < 0.7:
                entries = entries[:-4] + struct.pack(e + "HH", int(
                    rng.integers(0, 10)), 0)
        block = ((b"MM" if e == ">" else b"II") + struct.pack(e + "HI", 42, 8)
                 + struct.pack(e + "H", n + int(rng.integers(0, 2)))
                 + entries + bytes(int(rng.integers(0, 40))))
        block = block[:int(rng.integers(len(block) - 20, len(block) + 1))]
        data = (_png_with(png, [block]) if k % 2
                else _jpeg_with(jpg, [b"Exif\0\0" + block]))
        got, want = _imread_both(tmp_path, f"r{k}.{'png' if k % 2 else 'jpg'}",
                                 data)
        _same(got, want)
        differ += not np.array_equal(got, image_io.decode_image(data))
    assert differ > 20, differ


def orientation_fixtures():
    """{name: bytes}: a 7 x 5 image in PNG, JPEG and WebP at orientations
    1-8, each written by PIL with its EXIF data."""
    out = {}
    img = golden_input(84, 5, 7)
    for o in range(1, 9):
        exif = Image.Exif()
        exif[0x0112] = o
        for fmt, kw in (("png", {}), ("jpg", dict(quality=95)),
                        ("webp", dict(lossless=True))):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, {"jpg": "JPEG"}.get(
                fmt, fmt.upper()), exif=exif, **kw)
            out[f"exif_o{o}_7x5.{fmt}"] = buf.getvalue()
    return out


def _orientation_digests(files, directory):
    out = {"source": "cv2 5.0.0 imread (flipped to RGB) and PIL 12.1.0 "
                     "convert('RGB') of each file, RGB uint8",
           "decode": {}}
    for name, data in sorted(files.items()):
        (directory / name).write_bytes(data)
        rgb = {"cv2": cv2.imread(str(directory / name))[..., ::-1],
               "pil": _pil(data)}
        out["decode"][name] = {how: {"shape": list(v.shape),
                                     "sha256": _sha(v)}
                               for how, v in rgb.items()}
    return out


def test_orientation_fixtures_rebuilt(tmp_path):
    """The committed orientation fixtures are PIL's bytes, digests.json
    holds cv2.imread's (oriented) and PIL's (not) readings of them, and
    the port gives both with its readers."""
    d = FIXTURES / "orientation"
    files = orientation_fixtures()
    assert sorted(p.name for p in d.iterdir()) == sorted(
        [*files, "digests.json"])
    for name, data in files.items():
        assert (d / name).read_bytes() == data, name
    golden = json.loads((d / "digests.json").read_text())
    assert golden == json.loads(json.dumps(_orientation_digests(
        files, tmp_path)))
    for name, by_how in golden["decode"].items():
        for how, want in by_how.items():
            got = image_io.decode_image(files[name], reader=how)
            assert [list(got.shape), _sha(got)] == [want["shape"],
                                                    want["sha256"]], name


if __name__ == "__main__":
    write_fixtures()
    sys.exit(0)
