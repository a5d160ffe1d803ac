"""The port's JPEG codec and the blind branch against cv2, PIL and the JAX
package, on the CPU at small sizes: `data/jpeg.py` (the host library built
from `csrc/host/jpeg.cc` by `data/host.py`), `image_io.imread_rgb` on JPEG,
`degradations.jpeg_roundtrip` and `blind_degrade`, `data/native.py`, and the
golden digests of `tests/fixtures/jpeg` that `chip_smoke.py` holds the codec
to on the card's host.

Tolerances:
  * `decode_jpeg` against `cv2.imdecode` (flipped to RGB) and PIL's
    `convert("RGB")`: bit-equal, on files both write (4:4:4, 4:2:2, 4:4:0,
    4:2:0, 4:1:1, grey, restart intervals, optimized Huffman tables, odd
    sizes, quality 75-100), and on RGB-coded files;
  * CMYK and YCCK files (PIL's, and re-labelled by their Adobe marker):
    `decode_jpeg(data, "pil")` bit-equal to PIL and `decode_jpeg(data,
    "cv2")` to cv2, which differ by up to 2 levels; the two CMYK -> RGB
    rules measured on all 65,536 (C, K) pairs; `ycck_to_cmyk` and
    `cmyk_to_rgb` equal to their numpy versions;
  * `encode_jpeg` against `cv2.imencode`'s bytes: equal, at quality
    80-100 and odd sizes;
  * `jpeg_roundtrip` against the JAX package's on the same generator: the
    values bit-equal and the next draw equal;
  * `blind_degrade` (the default path) against the JAX package's cv2 path
    with cv2's IPP off (cv2's own resize): the draws equal; the values
    within the data tests' 8-bit rule over all the seeds (quantised to 8
    bits, at most 1e-4 of the values one level apart, none more). The
    port's `filter2d` sums in float64 and its linear resize is within an
    ulp or two of cv2's, so a uint8 truncated before the JPEG encode can
    flip and move its blocks after the JPEG and the resize. On this test's
    40 seeds at 80 -> 64 px, 11 (27.5%) come out bit-equal and the other 29
    within 6e-8, none flipped; elsewhere one seed in 100 flipped (8 values
    one level apart, 6.5e-6 of 100 seeds' values);
  * `blind_degrade(native=True)` and every function of `data/native.py`
    against the JAX package's native library built from
    `native/src/hifidiff_native.cc` into the test's own directory with
    `native/build.sh`'s flags: bit-equal.
"""

import hashlib
import io
import json
import pathlib
import subprocess

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from hifidiff_tpu.data import degradations as jdeg  # noqa: E402
from hifidiff_tpu_torch.data import degradations as deg  # noqa: E402
from hifidiff_tpu_torch.data import host, image_io, jpeg  # noqa: E402
from hifidiff_tpu_torch.data.image_files import golden_input  # noqa: E402

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "jpeg"
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _face(seed, h, w, amp=40):
    """Ramps with noise: every block has AC energy, chroma varies."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([x * 255 // max(1, w - 1), y * 255 // max(1, h - 1),
                     (x * y) % 256], -1)
    return np.clip(base + rng.integers(-amp, amp + 1, base.shape), 0,
                   255).astype(np.uint8)


def _cv2_jpeg(rgb, q, sampling="420", restart=0):
    img = rgb[..., ::-1] if rgb.ndim == 3 else rgb
    params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              SAMPLING[sampling], cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    return cv2.imencode(".jpg", img, params)[1].tobytes()


def _pil_jpeg(img, **kw):
    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", **kw)
    return out.getvalue()


def _references(data, flags=cv2.IMREAD_COLOR):
    a = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
    return a[..., ::-1], np.asarray(Image.open(io.BytesIO(data)).convert(
        "RGB"))


def _check_decode(data, flags=cv2.IMREAD_COLOR):
    got = jpeg.decode_jpeg(data)
    for ref in _references(data, flags):
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


SIZES = [(161, 157), (1, 1), (2, 3), (9, 33), (16, 5)]


@pytest.mark.parametrize("sampling", ["444", "422", "440", "420", "411"])
@pytest.mark.parametrize("q", [75, 90, 100])
def test_decode_cv2_files(sampling, q):
    for i, (h, w) in enumerate(SIZES):
        for restart in (0, 1 + i % 3):
            _check_decode(_cv2_jpeg(_face(i, h, w), q, sampling, restart))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("q", [75, 95, 100])
def test_decode_pil_files(subsampling, q):
    for i, (h, w) in enumerate(SIZES):
        _check_decode(_pil_jpeg(_face(i, h, w), quality=q,
                                subsampling=subsampling))


@pytest.mark.parametrize("writer", ["cv2", "pil"])
def test_decode_grey_optimized_and_exif(writer):
    """Grey files come out repeated over three channels; PIL's optimized
    Huffman tables and an EXIF block decode like the rest, its orientation
    ignored as `Image.open` ignores it (cv2 rotates unless told not to:
    `IMREAD_IGNORE_ORIENTATION`)."""
    for i, (h, w) in enumerate(SIZES):
        img = _face(i, h, w)
        grey = np.ascontiguousarray(img[..., 1])
        if writer == "cv2":
            _check_decode(_cv2_jpeg(grey, 85, restart=i))
        else:
            _check_decode(_pil_jpeg(grey, quality=85))
            _check_decode(_pil_jpeg(img, quality=85, optimize=True))
            exif = Image.Exif()
            exif[0x0112] = 6   # orientation: rotate 90
            _check_decode(_pil_jpeg(img, quality=85, exif=exif),
                          cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)


@pytest.mark.parametrize("q", range(80, 101))
def test_encode_matches_cv2_bytes(q):
    for i, (h, w) in enumerate(SIZES + [(64, 64), (17, 19)]):
        img = _face(i, h, w)
        assert jpeg.encode_jpeg(img, q) == cv2.imencode(
            ".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes()


def _forge(data, at, value):
    return data[:at] + bytes([value]) + data[at + 1:]


def _sof_offset(data):
    return next(i for i in range(len(data) - 1)
                if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1))


def _adobe_rgb(data):
    """The file with its JFIF APP0 replaced by an Adobe APP14 of transform
    0 (libjpeg then reads the components as RGB)."""
    assert data[2:4] == b"\xff\xe0"
    n = (data[4] << 8) | data[5]
    app14 = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    return data[:2] + app14 + data[4 + n:]


BASE = _cv2_jpeg(_face(3, 24, 24), 90)


@pytest.mark.parametrize("data, match", [
    (_forge(BASE, _sof_offset(BASE) + 1, 0xC9), "arithmetic"),
    (_forge(BASE, _sof_offset(BASE) + 1, 0xC3), "lossless"),
    (_forge(BASE, _sof_offset(BASE) + 1, 0xC5), "hierarchical"),
    (_forge(BASE, _sof_offset(BASE) + 4, 12), "12-bit"),
    (_forge(BASE, _sof_offset(BASE) + 1, 0xCA), "SOF10"),
    (BASE[:-2], "truncated"),
    (b"\x89PNG\r\n\x1a\n", "not a JPEG"),
])
def test_decoder_refusals(data, match):
    with pytest.raises(jpeg.JPEGError, match=match):
        jpeg.decode_jpeg(data)


def _pil_cmyk(img, **kw):
    """PIL's CMYK JPEG of a (h, w, 4) uint8 image (stored inverted, Adobe
    transform 0)."""
    out = io.BytesIO()
    Image.fromarray(img, "CMYK").save(out, "JPEG", **kw)
    return out.getvalue()


def _pil_reads(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _cv2_reads(data):
    out = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if out is None else np.ascontiguousarray(out[..., ::-1])


def _check_four_components(data, space):
    """The file read as each library reads it, through the library and
    through the plain colour steps on its components; its coefficients
    equal to the plain decoder's; refused without a reader."""
    px, got_space = jpeg.components(data)
    assert got_space == space
    cmyk = jpeg.ycck_to_cmyk_plain(px) if space == "ycck" else px
    for how, ref in (("pil", _pil_reads(data)), ("cv2", _cv2_reads(data))):
        got = jpeg.decode_jpeg(data, how)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(jpeg.cmyk_to_rgb_plain(cmyk, how), got)
    for a, b in zip(jpeg.coefficients(data), jpeg.coefficients_plain(data)):
        assert a["coef"].tobytes() == b["coef"].tobytes()
    with pytest.raises(jpeg.JPEGError, match=f"a {space.upper()} JPEG: pass "
                       "reader='cv2' or 'pil'"):
        jpeg.decode_jpeg(data)
    return px


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_cmyk_and_ycck_files(subsampling, progressive):
    """PIL's CMYK files (its subsampling on the first three components)
    at odd sizes and qualities 75 and 95, with restart intervals, each also
    without its Adobe marker (CMYK) and re-labelled as YCCK (transform 2,
    and 1, which libjpeg reads as YCCK too): each library's RGB bit for
    bit by its reader."""
    from hifidiff_tpu_torch.data.image_files import (jpeg_adobe_transform,
                                                     jpeg_without_adobe)

    for i, (h, w) in enumerate(SIZES):
        img = np.concatenate([_face(i, h, w), _face(i + 7, h, w)[..., :1]],
                             -1)
        img[..., 3] = img[..., 3] // (1 + i)
        kw = dict(quality=(75, 95)[i % 2], subsampling=subsampling,
                  progressive=progressive)
        if i % 2 and not progressive:
            kw["restart_marker_blocks"] = 1 + i
        data = _pil_cmyk(img, **kw)
        _check_four_components(data, "cmyk")
        _check_four_components(jpeg_without_adobe(data), "cmyk")
        for transform in (2, 1):
            _check_four_components(jpeg_adobe_transform(data, transform),
                                   "ycck")


def test_cmyk_to_rgb_rules_over_every_pair():
    """The two rules on all 65,536 (C, K) pairs (M and Y other values in
    step): PIL's through `Image.fromarray(..., "CMYK").convert("RGB")` of
    the inverted samples (its "CMYK;I" raw mode), cv2's through
    `cv2.imdecode` of a 2048 x 2048 CMYK file of flat 8 x 8 blocks at
    quality 100, whose samples decode exactly; the library's and the plain
    versions' equal on them; they differ by up to 2 levels."""
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    cmyk = np.stack([c, (c + 85) % 256, (c + 170) % 256, k], -1).astype(
        np.uint8)
    pil = np.asarray(Image.fromarray(255 - cmyk, "CMYK").convert("RGB"))
    np.testing.assert_array_equal(jpeg.cmyk_to_rgb_plain(cmyk, "pil"), pil)
    data = _pil_cmyk(np.repeat(np.repeat(255 - cmyk, 8, 0), 8, 1),
                     quality=100, subsampling=0)
    px, space = jpeg.components(data)
    assert space == "cmyk" and px[::8, ::8].tobytes() == cmyk.tobytes()
    cv = _cv2_reads(data)[::8, ::8]
    np.testing.assert_array_equal(jpeg.cmyk_to_rgb_plain(cmyk, "cv2"), cv)
    for how, want in (("pil", pil), ("cv2", cv)):
        np.testing.assert_array_equal(jpeg.cmyk_to_rgb(cmyk, how), want)
    assert int(np.abs(pil.astype(int) - cv).max()) == 2
    with pytest.raises(ValueError, match="needs a reader"):
        jpeg.cmyk_to_rgb(cmyk, None)


def test_ycck_to_cmyk_host_and_plain():
    """`ycck_to_cmyk` (jdcolor.c's ycck_cmyk_convert) against its numpy
    version on every (Cb, Cr) pair at 16 levels of Y and K, the clamps at
    both ends among them."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    px = np.concatenate([
        np.stack([np.full_like(cb, y), cb, cr, np.full_like(cb, 255 - y)],
                 -1) for y in range(0, 256, 17)]).astype(np.uint8)
    got = jpeg.ycck_to_cmyk(px)
    np.testing.assert_array_equal(jpeg.ycck_to_cmyk_plain(px), got)
    assert got[..., 3].tobytes() == px[..., 3].tobytes()
    assert got[..., :3].min() == 0 and got[..., :3].max() == 255


@pytest.mark.parametrize("case", ["keep_rgb", "ids without markers",
                                  "Adobe 0 over YCbCr"])
def test_rgb_coded_files(case):
    """Three-component files libjpeg reads as RGB, which PIL and cv2 read
    alike: PIL's `keep_rgb=True` files (4:4:4: PIL subsamples no RGB), the same
    without their Adobe marker (ids 'R', 'G', 'B'), and a YCbCr file whose
    JFIF marker became an Adobe one of transform 0; the other transforms
    (1, 2, 7) read as YCbCr. No reader needed."""
    from hifidiff_tpu_torch.data.image_files import (jpeg_adobe_transform,
                                                     jpeg_without_adobe)

    for i, (h, w) in enumerate(SIZES):
        img = _face(i + 20, h, w)
        if case == "Adobe 0 over YCbCr":
            data = _adobe_rgb(_cv2_jpeg(img, 90, ("444", "420")[i % 2]))
        else:
            data = _pil_jpeg(img, quality=(75, 90)[i % 2], keep_rgb=True)
            if case != "keep_rgb":
                data = jpeg_without_adobe(data)
        assert jpeg.components(data)[1] == "rgb"
        _check_decode(data)
        if case != "ids without markers":
            for transform in (1, 2, 7):
                other = jpeg_adobe_transform(data, transform)
                assert jpeg.components(other)[1] == "ycbcr"
                _check_decode(other)


def test_one_byte_mutants_of_a_cmyk_file():
    """300 seeded one-byte mutants of PIL's 4:2:0 CMYK file: where PIL and
    cv2 both read one, the port reads each library's pixels by its reader
    or refuses it, naming corrupt or truncated data (libjpeg reads those
    with a warning); where either refuses, the port refuses. About 1 s."""
    img = np.concatenate([_face(5, 29, 37), _face(6, 29, 37)[..., :1]], -1)
    data = _pil_cmyk(img, quality=90, subsampling=2)
    rng = np.random.default_rng(40)
    counts = {"read": 0, "refused": 0, "refused, read by both": 0}
    for _ in range(300):
        m = bytearray(data)
        at = int(rng.integers(2, len(data)))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            m[at] = int(rng.integers(0, 256))
        elif kind == 1:
            m[at] ^= 1 << int(rng.integers(0, 8))
        else:
            m = m[:at]
        m = bytes(m)
        refs = {}
        for how, fn in (("pil", _pil_reads), ("cv2", _cv2_reads)):
            try:
                refs[how] = fn(m)
            except Exception:   # what PIL raises on a file it refuses
                refs[how] = None
        try:
            got = {how: jpeg.decode_jpeg(m, how) for how in refs}
        except jpeg.JPEGError as e:
            if any(r is None for r in refs.values()):
                counts["refused"] += 1
            else:
                assert "corrupt" in str(e) or "truncated" in str(e) \
                    or "a second" in str(e), str(e)
                counts["refused, read by both"] += 1
            continue
        for how, ref in refs.items():
            assert ref is not None, (at, kind, how)
            np.testing.assert_array_equal(got[how], ref)
        counts["read"] += 1
    assert counts["read"] > 50 and counts["refused"] > 5, counts


def test_encoder_refusals():
    for img in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 4),
                                                          np.uint8),
                np.zeros((4, 4), np.uint8)):
        with pytest.raises(jpeg.JPEGError, match=r"\(H, W, 3\) uint8"):
            jpeg.encode_jpeg(img, 90)


def test_golden_digests_rebuilt_by_cv2_and_pil():
    """digests.json holds what cv2 and PIL decode from the golden files
    and what cv2 writes for the seeded inputs
    (`data/image_files.golden_input`); the port gives the same digests; the
    refused files are refused."""
    golden = json.loads((FIXTURES / "digests.json").read_text())
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 200_000
    for name, want in golden["decode"].items():
        data = (FIXTURES / name).read_bytes()
        for rgb in (*_references(data), jpeg.decode_jpeg(data)):
            assert list(rgb.shape) == want["shape"]
            assert hashlib.sha256(np.ascontiguousarray(
                rgb).tobytes()).hexdigest() == want["sha256"], name
    for name, by_how in golden["decode_by_reader"].items():
        data = (FIXTURES / name).read_bytes()
        refs = {"pil": _pil_reads(data), "cv2": _cv2_reads(data)}
        for how, want in by_how.items():
            for rgb in (refs[how], jpeg.decode_jpeg(data, how)):
                assert [list(rgb.shape), hashlib.sha256(rgb.tobytes(
                    )).hexdigest()] == [want["shape"], want["sha256"]], name
        assert by_how["pil"] != by_how["cv2"], name
        with pytest.raises(jpeg.JPEGError, match="pass reader='cv2' or "
                           "'pil'"):
            jpeg.decode_jpeg(data)
    assert {"pil_cmyk_16x16.jpg", "ycck_444_q90_37x29.jpg",
            "cmyk_no_adobe_420_q90_37x29.jpg"} <= set(
        golden["decode_by_reader"])
    for name, what in golden["refuse"].items():
        with pytest.raises(jpeg.JPEGError, match=what):
            jpeg.decode_jpeg((FIXTURES / name).read_bytes())
    for e in golden["encode"]:
        img = golden_input(e["seed"], e["height"], e["width"])
        for data in (cv2.imencode(".jpg", img[..., ::-1],
                                  [cv2.IMWRITE_JPEG_QUALITY,
                                   e["quality"]])[1].tobytes(),
                     jpeg.encode_jpeg(img, e["quality"])):
            assert hashlib.sha256(data).hexdigest() == e["sha256"], e
    samplings = {n.split("_")[1] for n in golden["decode"]}
    assert {"444", "422", "440", "420", "411", "grey"} <= samplings
    assert any("rst" in n for n in golden["decode"])


def test_imread_rgb_reads_jpeg(tmp_path):
    img = _face(4, 37, 29)
    (tmp_path / "a.jpg").write_bytes(_pil_jpeg(img, quality=92))
    cv2.imwrite(str(tmp_path / "b.jpeg"), img[..., ::-1])
    for name in ("a.jpg", "b.jpeg"):
        want = np.asarray(Image.open(tmp_path / name).convert("RGB"))
        np.testing.assert_array_equal(
            image_io.imread_rgb(str(tmp_path / name)), want)
    (tmp_path / "c.jpg").write_bytes(_pil_jpeg(img, progressive=True))
    cv2.imwrite(str(tmp_path / "d.bmp"), img)
    for name in ("c.jpg", "d.bmp"):
        want = np.asarray(Image.open(tmp_path / name).convert("RGB"))
        np.testing.assert_array_equal(
            image_io.imread_rgb(str(tmp_path / name)), want)
    Image.fromarray(img).save(tmp_path / "e.gif")
    with pytest.raises(image_io.ImageFormatError,
                       match="e.gif: a GIF file: the port reads PNG, JPEG"):
        image_io.imread_rgb(str(tmp_path / "e.gif"))


def test_host_build_failure_raises_with_the_compiler_output(tmp_path,
                                                            monkeypatch):
    (tmp_path / "broken.cc").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(host, "HOST_SRC", tmp_path)
    monkeypatch.setattr(host, "SOURCES", ("broken.cc",))
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed[^$]*broken.cc"):
        host._build(tmp_path / "libx.so")
    assert not list(tmp_path.glob("*.tmp"))
    assert "cached" in host.library().build_log or "g++" in \
        host.library().build_log


# -- the round trip and the blind branch -------------------------------------

def _same_next_draw(a, b):
    assert a.uniform() == b.uniform()


@pytest.mark.parametrize("side", [16, 33, 64, 128])
def test_jpeg_roundtrip_as_jax(side):
    for seed in range(4):
        img = np.random.default_rng(seed).uniform(
            -0.05, 1.05, (side, side + seed, 3)).astype(np.float32)
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        got = deg.jpeg_roundtrip(a, img)
        want = jdeg.jpeg_roundtrip(b, np.ascontiguousarray(img[..., ::-1]))
        np.testing.assert_array_equal(got, want[..., ::-1])
        _same_next_draw(a, b)


@pytest.fixture
def cv2_own():
    """cv2's own resize algorithm for the JAX package's calls (IPP off)."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _levels(got, want):
    return np.abs(np.rint(got * 255).astype(int)
                  - np.rint(want * 255).astype(int))


def test_blind_degrade_draws_as_jax(cv2_own):
    from hifidiff_tpu.data import native as jnative

    assert not jnative.available()   # the JAX package takes its cv2 path
    img = np.random.default_rng(20).uniform(0, 1, (80, 80, 3)).astype(
        np.float32)
    bgr = np.ascontiguousarray(img[..., ::-1])
    levels, equal = [], 0
    for seed in range(40):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        got = deg.blind_degrade(a, img, 64)
        want = jdeg.blind_degrade(b, bgr, 64)[..., ::-1]
        _same_next_draw(a, b)
        assert got.shape == want.shape == (64, 64, 3)
        assert got.dtype == np.float32
        equal += np.array_equal(got, want)
        levels.append(_levels(got, want))
    d = np.concatenate([x.ravel() for x in levels])
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (d.max(),
                                                     (d > 0).mean())
    assert equal >= 8    # the docstring's share: 11 of 40


def _build_jax_native(tmp_path):
    """The JAX package's native source built into `tmp_path` with
    `native/build.sh`'s flags (never into hifidiff_tpu/data/_native)."""
    lib = tmp_path / "libhifidiff_native.so"
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                    "-fPIC", "-pthread", "-o", str(lib),
                    str(REPO / "native" / "src" / "hifidiff_native.cc")],
                   check=True)
    return lib


def test_native_path_as_jax_native(tmp_path, monkeypatch):
    from hifidiff_tpu.data import native as jnative
    from hifidiff_tpu_torch.data import native

    monkeypatch.setattr(jnative, "_LIB_PATH", str(_build_jax_native(
        tmp_path)))
    monkeypatch.setattr(jnative, "_lib", None)
    assert jnative.available()
    rng = np.random.default_rng(21)
    img = rng.uniform(0, 1, (80, 72, 3)).astype(np.float32)
    k = deg.random_mixed_kernel(rng, 9)
    for got, want in (
            (native.resize(img, (33, 41)), jnative.resize(img, (33, 41))),
            (native.resize(img, (100, 90), cubic=False),
             jnative.resize(img, (100, 90), cubic=False)),
            (native.resize_batch(np.stack([img, img * 0.5]), (20, 24),
                                 num_threads=2),
             jnative.resize_batch(np.stack([img, img * 0.5]), (20, 24),
                                  num_threads=2)),
            (native.filter2d(img, k), jnative.filter2d(img, k)),
            (native.add_gaussian_noise(img, 0.02, 7),
             jnative.add_gaussian_noise(img, 0.02, 7)),
            (native.quantize8(img), jnative.quantize8(img)),
            (native.degrade_stage1(img, k, (30, 30), 0.01, 5),
             jnative.degrade_stage1(img, k, (30, 30), 0.01, 5))):
        np.testing.assert_array_equal(got, want)
    bgr = np.ascontiguousarray(img[..., ::-1])
    for seed in range(12):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        got = deg.blind_degrade(a, img, 64, native=True)
        want = jdeg.blind_degrade(b, bgr, 64)[..., ::-1]
        np.testing.assert_array_equal(got, want)
        _same_next_draw(a, b)
