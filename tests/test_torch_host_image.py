"""The host image library (`hifidiff_tpu_torch/csrc/host/image.cc`, built by
`data/host.py`) against the plain versions it replaces, on the CPU, and
against cv2 and PIL as yardsticks.

Every library function is held to its plain numpy version bit for bit
(equal bytes, so -0.0 and 0.0 differ too): `resize_cv2` (cubic float32 and
uint8, linear float32), `resize_pil` (bicubic, nearest), `filter2d` and
`decode_png`, over sizes 1-300, up- and downscales, the ratios 4/3 and 6/5,
1-4 channels and 2-D arrays; 9 x 9, 11 x 11 and uneven kernels on images
smaller than the kernel; PNG files of every colour type and bit depth the
decoder reads (Adam7 and 16-bit files, and BMP, in
tests/test_torch_image_formats.py), rows through the five filters, the
image data split over many IDAT chunks, and every refusal with the same
message from both. The yardsticks, as tests/test_torch_data.py holds the
plain versions to them: `cv2.resize` with IPP off (cv2's own algorithm)
bit-equal for cubic float32, 5e-7 for linear, one level for uint8 cubic
(bit-equal at the datasets' shapes, tests/test_torch_data.py; where an
output row's bytes end past cv2's last full vector, cv2 rounds the rest in
fixed point, and one value of the sweep falls one level apart); PIL
bit-equal; `cv2.filter2D` 1e-6; PNG files decoded as PIL and cv2 decode
them, bit-equal.
"""

import io
import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from hifidiff_tpu_torch.data import degradations as deg  # noqa: E402
from hifidiff_tpu_torch.data import image_io, resize  # noqa: E402


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, got.shape, want.dtype, want.shape)
    assert got.tobytes() == want.tobytes(), np.abs(
        got.astype(np.float64) - want.astype(np.float64)).max()


def _image(rng, shape, dtype):
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.uniform(0, 1, shape).astype(np.float32)


def _seed(*case):
    return zlib.crc32(repr(case).encode())


def _shape(hw, ch):
    return hw if ch is None else (*hw, ch)


# (source (h, w), output (h, w), channels: None for a 2-D array)
_RATIOS = [((160, 120), (120, 90)), ((120, 90), (160, 120)),   # 4/3
           ((150, 125), (125, 150)), ((125, 150), (150, 125))]  # 6/5


def _sweep(seed, n):
    """Ratios 4/3 and 6/5, the 1-pixel edges, the datasets' shapes, and `n`
    random pairs of sides 1-300, over 2-D arrays and 1-4 channels."""
    rng = np.random.default_rng(seed)
    cases = [(s, d, ch) for (s, d), ch in zip(_RATIOS, (None, 1, 3, 4))]
    cases += [((1, 1), (5, 7), 3), ((7, 5), (1, 1), None), ((1, 9), (4, 1), 2),
              ((300, 300), (1, 300), 1), ((160, 160), (128, 128), 3),
              ((256, 256), (128, 128), 3), ((128, 128), (32, 32), 3),
              ((32, 32), (128, 128), 3)]
    for _ in range(n):
        src = tuple(int(v) for v in rng.integers(1, 301, 2))
        dst = tuple(int(v) for v in rng.integers(1, 301, 2))
        cases.append((src, dst, [None, 1, 2, 3, 4][int(rng.integers(5))]))
    return cases


CV2_CASES = _sweep(0, 12)
PIL_CASES = _sweep(1, 10)


def _cv2_own(img, size, flag):
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        return cv2.resize(img, size, interpolation=flag)
    finally:
        cv2.ipp.setUseIPP(was)


@pytest.mark.parametrize("mode", ["cubic", "linear", "cubic_u8"])
@pytest.mark.parametrize("src, dst, ch", CV2_CASES)
def test_resize_cv2_equals_plain(src, dst, ch, mode):
    rng = np.random.default_rng(_seed(src, dst, ch))
    dtype = np.uint8 if mode == "cubic_u8" else np.float32
    img = _image(rng, _shape(src, ch), dtype)
    how = mode.split("_")[0]
    size = (dst[1], dst[0])
    got = resize.resize_cv2(img, size, how)
    _same_bits(got, resize.resize_cv2_plain(img, size, how))
    if (ch or 1) <= 4:   # cv2's own algorithm as the yardstick
        flag = cv2.INTER_CUBIC if how == "cubic" else cv2.INTER_LINEAR
        own = _cv2_own(img, size, flag).reshape(got.shape)
        if mode == "cubic":
            _same_bits(got, own)
        else:   # linear float32; uint8 where cv2's scalar tail rounds
            assert np.abs(got.astype(np.float64) - own).max() <= (
                1 if mode == "cubic_u8" else 5e-7)


@pytest.mark.parametrize("mode", ["bicubic", "nearest"])
@pytest.mark.parametrize("src, dst, ch", PIL_CASES)
def test_resize_pil_equals_plain(src, dst, ch, mode):
    rng = np.random.default_rng(_seed(src, dst, ch, 1))
    img = _image(rng, _shape(src, ch), np.uint8)
    size = (dst[1], dst[0])
    got = resize.resize_pil(img, size, mode)
    _same_bits(got, resize.resize_pil_plain(img, size, mode))
    if ch in (None, 3):   # PIL's L and RGB (it resizes RGBA premultiplied)
        flag = Image.BICUBIC if mode == "bicubic" else Image.NEAREST
        _same_bits(got, np.asarray(Image.fromarray(img).resize(size, flag)))


def test_resize_refusals_and_same_size():
    img = np.zeros((6, 5, 3), np.float32)
    for fn in (resize.resize_cv2, resize.resize_cv2_plain):
        with pytest.raises(ValueError, match="cubic only"):
            fn(img.astype(np.uint8), (3, 3), "linear")
        with pytest.raises(ValueError, match="float32 or uint8"):
            fn(img.astype(np.float64), (3, 3))
        with pytest.raises(ValueError, match="'cubic' or 'linear'"):
            fn(img, (3, 3), "area")
        with pytest.raises(ValueError, match=r"\(H, W\) or \(H, W, C\)"):
            fn(img[None], (3, 3))
        same = fn(img, (5, 6), "area")   # the same size: a copy, any mode
        assert same is not img and np.array_equal(same, img)
    for fn in (resize.resize_pil, resize.resize_pil_plain):
        with pytest.raises(ValueError, match="takes uint8"):
            fn(img, (3, 3))
        with pytest.raises(ValueError, match="'bicubic' or 'nearest'"):
            fn(img.astype(np.uint8), (3, 3), "box")
    with pytest.raises(ValueError, match="at least 1"):
        resize.resize_cv2(img, (0, 3))
    with pytest.raises(ValueError, match="at least 1"):
        resize.resize_pil(img[:0].astype(np.uint8), (3, 3))


# -- filter2d -----------------------------------------------------------------

def _uneven_kernel(rng):
    """A (7, 4) kernel with negative taps: every tap weighs in the sum's
    order."""
    return rng.normal(size=(7, 4)).astype(np.float32)


@pytest.mark.parametrize("kernel", ["iso9", "mixed11", "uneven7x4",
                                    "float64"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 3, 3), (4, 9, 1), (5, 5),
                                   (10, 10, 4), (3, 40, 2), (40, 33, 3),
                                   (128, 128, 3), (160, 160, 3)])
def test_filter2d_equals_plain(shape, kernel):
    rng = np.random.default_rng(sum(shape) + len(kernel))
    img = _image(rng, shape, np.float32)
    k = {"iso9": lambda: deg.bivariate_gaussian_kernel(9, 0.6, 0.6, 0.0),
         "mixed11": lambda: deg.random_mixed_kernel(rng, 11),
         "uneven7x4": lambda: _uneven_kernel(rng),
         "float64": lambda: rng.normal(size=(5, 5))}[kernel]()
    got = deg.filter2d(img, k)
    _same_bits(got, deg.filter2d_plain(img, k))
    if min(shape[:2]) >= max(k.shape) and kernel in ("iso9", "mixed11"):
        # cv2's own reflection where the image spans the kernel
        assert np.abs(got - cv2.filter2D(img, -1, k)).max() <= 1e-6


def test_filter2d_refusals():
    for bad in (np.zeros((4, 4), np.float64), np.zeros((2, 4, 4, 1),
                                                       np.float32),
                np.zeros((0, 4), np.float32)):
        with pytest.raises(ValueError, match="filter2d takes a float32"):
            deg.filter2d(bad, np.ones((3, 3), np.float32))
    with pytest.raises(ValueError, match="non-empty kernel"):
        deg.filter2d(np.zeros((4, 4), np.float32), np.ones((0, 3)))


# -- the PNG decoder ----------------------------------------------------------

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_rows(rows, bpp, filters):
    """(h, stride) uint8 scanlines as the filtered stream, row y through
    `filters[y % len(filters)]`."""
    h, stride = rows.shape
    r = rows.astype(np.int16)
    up = np.zeros_like(r)
    up[1:] = r[:-1]
    left = np.zeros_like(r)
    left[:, bpp:] = r[:, :-bpp]
    corner = np.zeros_like(r)
    corner[1:, bpp:] = r[:-1, :-bpp]
    p = left + up - corner
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, corner))
    pred = (np.zeros_like(r), left, up, (left + up) // 2, paeth)
    out = np.empty((h, stride + 1), np.uint8)
    for y in range(h):
        f = filters[y % len(filters)]
        out[y, 0] = f
        out[y, 1:] = (r[y] - pred[f][y]) % 256
    return out.tobytes()


def _png(samples, depth, color, palette=None, filters=(0, 1, 2, 3, 4),
         idat_size=64, ihdr=None, raw=None):
    """A PNG of (h, w, channels) `samples` at bit depth `depth` (packed MSB
    first below 8), rows through `filters`, IDAT in `idat_size` pieces;
    `ihdr` replaces header fields, `raw` the inflated stream."""
    h, w, ch = samples.shape
    if depth < 8:
        bits = ((samples[..., 0, None] >> np.arange(depth - 1, -1, -1))
                & 1).astype(np.uint8).reshape(h, w * depth)
        rows = np.packbits(bits, axis=1)
    else:
        rows = samples.reshape(h, w * ch).astype(np.uint8)
    bpp = max(1, ch * depth // 8)
    stream = raw if raw is not None else _filter_rows(rows, bpp, filters)
    data = zlib.compress(stream, 6)
    head = dict(w=w, h=h, depth=depth, color=color, comp=0, flt=0, lace=0)
    head.update(ihdr or {})
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", head["w"], head["h"], head["depth"], head["color"],
        head["comp"], head["flt"], head["lace"]))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    out += b"".join(_chunk(b"IDAT", data[i:i + idat_size])
                    for i in range(0, len(data), idat_size))
    return out + _chunk(b"IEND", b"")


def _png_file(color, depth, h, w, filters=(0, 1, 2, 3, 4), seed=0):
    rng = np.random.default_rng(seed)
    ch = _CHANNELS[color]
    top = 1 << depth
    palette = None
    if color == 3:
        n = min(top, 3 + seed % top) if depth < 8 else 200
        palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        top = n
    samples = rng.integers(0, top, (h, w, ch))
    # smooth runs too, so every filter sees small residuals
    samples[: h // 2] = np.minimum(np.arange(w)[None, :, None] % top,
                                   top - 1)
    return _png(samples, depth, color, palette, filters), palette


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (6, 8)]


@pytest.mark.parametrize("filters", [(0, 1, 2, 3, 4), (3,), (4,)])
@pytest.mark.parametrize("hw", [(1, 1), (7, 3), (23, 37)])
@pytest.mark.parametrize("color, depth", PNG_KINDS)
def test_decode_png_equals_plain(color, depth, hw, filters):
    data, _ = _png_file(color, depth, *hw, filters=filters,
                        seed=color * 10 + depth)
    got = image_io.decode_png(data)
    assert got.shape == (*hw, 3) and got.dtype == np.uint8
    _same_bits(got, image_io.decode_png_plain(data))
    _same_bits(got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    if depth == 8:
        ocv = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        _same_bits(got, np.ascontiguousarray(ocv[..., ::-1]))


def test_decode_png_empty_image():
    """A header of height 0 decodes to an empty array in both versions."""
    data = _png(np.zeros((0, 5, 3), np.uint8), 8, 2)
    got = image_io.decode_png(data)
    assert got.shape == (0, 5, 3)
    _same_bits(got, image_io.decode_png_plain(data))


def test_png_stream_splits_into_many_idat_chunks():
    data, _ = _png_file(6, 8, 40, 50)
    offsets, pos = [], 8
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == b"IDAT":
            offsets.append(n)
        pos += 12 + n
    assert len(offsets) > 20
    got = image_io.decode_png(data)
    _same_bits(got, image_io.decode_png_plain(data))
    _same_bits(got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def _refusals():
    """(name, bytes, message pattern): every refusal of the decoder."""
    rgb = np.random.default_rng(3).integers(0, 256, (6, 5, 3))
    good = _png(rgb, 8, 2)
    pal = np.zeros((4, 3), np.uint8)
    idx = np.zeros((3, 4, 1), int)
    idx[0, 1], idx[2, 3] = 5, 9     # the largest index is named
    stride = 5 * 3
    out = [
        ("signature", b"GIF89a" + good[6:], "not a PNG file"),
        ("truncated chunk", good[:60], "truncated b'IDAT' chunk"),
        ("crc", good[:30] + bytes([good[30] ^ 1]) + good[31:],
         "bad CRC in the b'IHDR' chunk"),
        ("no IEND", good[:-12], r"no IEND chunk: the file is truncated"),
        ("PLTE length", _png(idx, 8, 3, np.zeros((2, 2), np.uint8)),
         "PLTE of 4 bytes"),
        ("no IHDR", good[:8] + good[33:], "no IHDR chunk"),
        ("colour type", _png(rgb, 8, 2, ihdr=dict(color=5)),
         "unknown colour type 5"),
        # an interlaced header over a non-interlaced stream: Adam7's
        # passes want 102 bytes of the 6 x 5 RGB image (rows of each pass
        # with their filter bytes), the stream holds 6 * 16
        ("interlaced", _png(rgb, 8, 2, ihdr=dict(lace=1)),
         r"interlaced \(Adam7\) image data holds 96 bytes, 102 wanted"),
        # a 16-bit file read without naming whose 16-bit reading to follow
        ("16-bit", _png(rgb, 8, 2, ihdr=dict(depth=16)),
         r"a 16-bit PNG: pass reader='cv2' or 'pil'"),
        ("depth", _png(rgb, 8, 2, ihdr=dict(depth=4)),
         "bit depth 4 with colour type 2 is not a valid PNG"),
        ("compression", _png(rgb, 8, 2, ihdr=dict(comp=1)),
         "unknown compression 1 or filter method 0"),
        ("no PLTE", _png(idx, 8, 3), "a palette file without PLTE"),
        ("no IDAT", good[:33] + _chunk(b"IEND", b""), "no IDAT chunk"),
        ("short stream", _png(rgb, 8, 2, raw=b"\0" * (6 * (stride + 1) - 1)),
         f"image data holds {6 * (stride + 1) - 1} bytes, "
         f"{6 * (stride + 1)} wanted"),
        ("filter type", _png(rgb, 8, 2, raw=bytes(
            [0] + [1] * stride + [0] + [2] * stride + [5] + [0] * stride)
            + b"\0" * (3 * (stride + 1))),
         "row 2: unknown filter type 5"),
        ("palette index", _png(idx, 8, 3, pal),
         "palette index 9 past the 4 entries of PLTE"),
        ("palette index, 2 bits", _png(np.full((3, 9, 1), 3), 2, 3,
                                       pal[:2]),
         "palette index 3 past the 2 entries of PLTE"),
    ]
    bad = bytearray(_png(rgb, 8, 2))
    pos = 33 + 8   # the first IDAT's body
    bad[pos:pos + 2] = b"\xff\xff"
    body_end = pos + struct.unpack(">I", bytes(bad[33:37]))[0]
    bad[body_end:body_end + 4] = struct.pack(
        ">I", zlib.crc32(bytes(bad[37:body_end])))
    out.append(("inflate", bytes(bad), "bad image data"))
    return out


REFUSALS = _refusals()


@pytest.mark.parametrize("name", [r[0] for r in REFUSALS])
def test_decode_png_refusals(name):
    data, match = next((d, m) for n, d, m in REFUSALS if n == name)
    messages = []
    for fn in (image_io.decode_png, image_io.decode_png_plain):
        with pytest.raises(image_io.PNGError, match=match) as e:
            fn(data)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_threads_loading_the_library_at_once_share_one_build(monkeypatch,
                                                             tmp_path):
    """Four threads that ask for the host library at once in a process that
    has not loaded it (a `Loader`'s threads on their first items) get one
    library from one build."""
    import threading

    from hifidiff_tpu_torch.data import host

    monkeypatch.setattr(host, "BUILD_DIR", tmp_path)
    host._load.cache_clear()
    got, errors = [], []

    def ask():
        try:
            got.append(host.library())
        except Exception as e:   # reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=ask) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(got) == 4 and all(lib is got[0] for lib in got)
        assert got[0].build_log != "cached"
        assert [p.suffix for p in tmp_path.iterdir()] == [".so"]
    finally:
        host._load.cache_clear()
