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
    sizes, quality 75-100);
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
    (_adobe_rgb(BASE), "RGB-coded"),
    (BASE[:-2], "truncated"),
    (b"\x89PNG\r\n\x1a\n", "not a JPEG"),
])
def test_decoder_refusals(data, match):
    with pytest.raises(jpeg.JPEGError, match=match):
        jpeg.decode_jpeg(data)


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
