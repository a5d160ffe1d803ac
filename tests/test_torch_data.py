"""The port's PNG data path against the JAX package and, as yardsticks,
cv2 and PIL, on the CPU at small sizes: `data/resize`, `data/image_io`,
`data/degradations`, the Multi-PIE and CelebA-HQ datasets (the blind
branch and JPEG files too; the codec's own tests: tests/test_torch_jpeg.py),
`ops/resize`, `cli/infer_cr` and the procedural faces' LR protocol.

Tolerances:
  * `resize_cv2` against `cv2.resize` with IPP off (cv2's own algorithm):
    cubic bit-equal (float32 and uint8), linear 5e-7 absolute. Where cv2 is
    built with IPP it hands the resize to IPP by default, whose sums round
    otherwise: against that, 5e-7 (float32; 1e-5 at the ratios where IPP
    takes another algorithm, 4/3 and 6/5 among them, measured 5.5e-6) and
    one level (uint8);
  * `resize_pil` against PIL: bit-equal;
  * `imread_rgb` against PIL's `convert("RGB")` and `cv2.imread` (flipped
    to RGB): bit-equal;
  * `filter2d` against `cv2.filter2D`: 1e-6; the degradations against the
    JAX package's on the same Generator seed: bit-equal draws (the next
    draw of both generators equal) and equal values (to_gray3: 1e-7,
    cv2's vector sum);
  * the datasets against the JAX package's classes, every key of every
    item, with cv2's IPP off: bit-equal (PIL paths and cv2 paths), but the
    blind branch's LR, held to the 8-bit rule below over its items. With
    IPP on, the JAX package's default on an IPP build, the cv2 paths are
    within 5e-7 (held in `test_pretraining_datasets`); on this random-noise
    tree 1.6e-4 of the Multi-PIE LR values then fall one level apart,
    IPP's rounding;
  * `ops/resize.resize_bicubic_torch` against the JAX package's and
    `F.interpolate(mode="bicubic", align_corners=False)`: 1e-5;
  * `infer_cr` against the JAX CLI on the same PNG and the same weights
    (the JAX CLI's random init through convert.py): the saved grids within
    one uint8 level;
  * the procedural faces' LR at 128 px against cv2's protocol: at most 1e-4
    of the values one level apart, none more.
"""

import io
import os
import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from hifidiff_tpu.data import degradations as jdeg  # noqa: E402
from hifidiff_tpu.data import multipie as jmultipie  # noqa: E402
from hifidiff_tpu.data import pretraining as jpretraining  # noqa: E402
from hifidiff_tpu_torch.data import degradations as deg  # noqa: E402
from hifidiff_tpu_torch.data import image_io, multipie, pretraining  # noqa: E402
from hifidiff_tpu_torch.data.image_files import png_filtered  # noqa: E402
from hifidiff_tpu_torch.data.resize import resize_cv2, resize_pil  # noqa: E402

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _face(rng, h, w, channels=3):
    """A smooth image with speckles: every filter type has work to do."""
    y, x = np.mgrid[:h, :w]
    base = np.stack([x * 255 // max(1, w - 1), y * 255 // max(1, h - 1),
                     (x * y) % 256, (x + 2 * y) % 256], -1)[..., :channels]
    noise = rng.integers(-20, 21, base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


# -- resize_cv2 ---------------------------------------------------------------

SHAPES = [((160, 160), (32, 32)), ((32, 32), (128, 128)),
          ((128, 128), (32, 32)), ((150, 150), (128, 128)),
          ((256, 256), (128, 128)), ((160, 128), (128, 128)),
          ((96, 128), (128, 96)), ((37, 53), (64, 21))]


def _cv2_resize(img, size, flag, ipp):
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        return cv2.resize(img, size, interpolation=flag)
    finally:
        cv2.ipp.setUseIPP(was)


@pytest.mark.parametrize("mode", ["cubic", "linear"])
@pytest.mark.parametrize("src, dst", SHAPES)
def test_resize_cv2_float32(src, dst, mode):
    rng = np.random.default_rng(hash((src, dst)) % 2 ** 32)
    img = rng.uniform(0, 1, (*src, 3)).astype(np.float32)
    flag = {"cubic": cv2.INTER_CUBIC, "linear": cv2.INTER_LINEAR}[mode]
    size = (dst[1], dst[0])
    got = resize_cv2(img, size, mode)
    own, ipp = (_cv2_resize(img, size, flag, i) for i in (False, True))
    assert got.dtype == np.float32 and got.shape == (*dst, 3)
    if mode == "cubic":
        np.testing.assert_array_equal(got, own)
    assert np.abs(got - own).max() <= 5e-7
    if np.array_equal(own, ipp) or np.abs(own - ipp).max() <= 5e-7:
        assert np.abs(got - ipp).max() <= 5e-7
    else:   # IPP took the ratio
        assert np.abs(got - ipp).max() <= 1e-5


@pytest.mark.parametrize("src, dst", SHAPES)
def test_resize_cv2_uint8_cubic(src, dst):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    size = (dst[1], dst[0])
    got = resize_cv2(img, size, "cubic").astype(int)
    own, ipp = (_cv2_resize(img, size, cv2.INTER_CUBIC, i).astype(int)
                for i in (False, True))
    assert np.array_equal(got, own)
    assert np.abs(got - ipp).max() <= 1


def test_resize_cv2_grey_and_same_size():
    img = np.random.default_rng(2).uniform(0, 1, (40, 30)).astype(np.float32)
    got = resize_cv2(img, (17, 23))
    assert got.shape == (23, 17)
    np.testing.assert_array_equal(
        got, _cv2_resize(img, (17, 23), cv2.INTER_CUBIC, False))
    assert np.array_equal(resize_cv2(img, (30, 40)), img)


# -- resize_pil ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["bicubic", "nearest"])
@pytest.mark.parametrize("src, dst", SHAPES + [((640, 480), (32, 32)),
                                               ((7, 5), (128, 3))])
def test_resize_pil_bit_equal(src, dst, mode):
    img = np.random.default_rng(3).integers(0, 256, (*src, 3),
                                            dtype=np.uint8)
    flag = {"bicubic": Image.BICUBIC, "nearest": Image.NEAREST}[mode]
    size = (dst[1], dst[0])
    want = np.asarray(Image.fromarray(img).resize(size, flag))
    got = resize_pil(img, size, mode)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# -- the PNG decoder ----------------------------------------------------------

def _pil_png(img, mode, **kw):
    im = Image.fromarray(img)
    im = (im.convert("P", palette=Image.ADAPTIVE, colors=kw.pop("colors"))
          if mode == "P" else im.convert(mode))
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _files():
    rng = np.random.default_rng(4)
    img = _face(rng, 47, 61)
    rgba = _face(rng, 47, 61, 4)
    out = {f"pil_{m}": _pil_png(img, m) for m in ("L", "RGB", "RGBA", "LA")}
    for colors in (2, 4, 16, 20, 256):   # bit depths 1, 2, 4, 8
        out[f"pil_P{colors}"] = _pil_png(img, "P", colors=colors)
    for name, arr in (("grey", img[..., 0]), ("bgr", img[..., ::-1]),
                      ("bgra", rgba[..., [2, 1, 0, 3]])):
        ok, enc = cv2.imencode(".png", np.ascontiguousarray(arr))
        assert ok
        out[f"cv2_{name}"] = enc.tobytes()
    from hifidiff_tpu_torch.utils.logging import png_bytes

    out["png_bytes_rgb"] = png_bytes(img)
    out["png_bytes_grey"] = png_bytes(img[..., 0])
    for ch in (1, 2, 3, 4):
        arr = rgba[..., :ch] if ch != 2 else rgba[..., [0, 3]]
        out[f"filtered_{ch}"] = png_filtered(arr, idat_size=500)
        for f in range(5):
            out[f"filtered_{ch}_only{f}"] = png_filtered(arr, filters=(f,))
    return out


FILES = _files()


@pytest.mark.parametrize("name", sorted(FILES))
def test_imread_rgb_bit_equal(tmp_path, name):
    data = FILES[name]
    path = tmp_path / "x.png"
    path.write_bytes(data)
    got = image_io.imread_rgb(str(path))
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    ocv = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
    assert got.dtype == np.uint8 and got.shape == pil.shape
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, ocv)


def test_every_filter_reaches_the_decoder():
    data = FILES["filtered_3"]
    body = zlib.decompress(b"".join(
        data[i + 8:i + 8 + struct.unpack(">I", data[i:i + 4])[0]]
        for i in _chunk_offsets(data, b"IDAT")))
    kinds = np.frombuffer(body, np.uint8).reshape(47, 61 * 3 + 1)[:, 0]
    assert set(kinds.tolist()) == {0, 1, 2, 3, 4}
    assert len(list(_chunk_offsets(data, b"IDAT"))) > 1


def _chunk_offsets(data, kind):
    pos = 8
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == kind:
            yield pos
        pos += 12 + n


def _with_header(data, **fields):
    """`data` with IHDR fields replaced (bit depth at 8, interlace at 12 of
    the chunk body) and its CRC made again."""
    body = bytearray(data[16:29])
    for off, v in fields.items():
        body[{"depth": 8, "interlace": 12}[off]] = v
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(body)))
    return data[:16] + bytes(body) + crc + data[33:]


@pytest.mark.parametrize("data, match", [
    (_with_header(FILES["png_bytes_rgb"], interlace=1), "interlaced"),
    (cv2.imencode(".png", np.full((4, 5, 3), 40000, np.uint16))[1].tobytes(),
     "16-bit"),
    (cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))[1].tobytes(),
     "not a PNG"),
    (FILES["png_bytes_rgb"][:-20], "truncated|IEND"),
    (FILES["png_bytes_rgb"][:40] + b"\x00" + FILES["png_bytes_rgb"][41:],
     "CRC"),
])
def test_decoder_refusals(data, match):
    with pytest.raises(image_io.PNGError, match=match):
        image_io.decode_png(data)


# -- degradations -------------------------------------------------------------

def _same_next_draw(a, b):
    assert a.uniform() == b.uniform()


@pytest.mark.parametrize("ksize", [9, 11])
def test_filter2d_against_cv2(ksize):
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (40, 33, 3)).astype(np.float32)
    k = deg.random_mixed_kernel(rng, ksize)
    want = cv2.filter2D(img, -1, k)
    assert np.abs(deg.filter2d(img, k) - want).max() <= 1e-6
    grey = img[..., 0].copy()
    assert np.abs(deg.filter2d(grey, k)
                  - cv2.filter2D(grey, -1, k)).max() <= 1e-6


def test_degradations_draw_as_jax():
    img = np.random.default_rng(6).uniform(0, 1, (24, 20, 3)).astype(
        np.float32)
    bgr = np.ascontiguousarray(img[..., ::-1])
    for seed in range(4):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(deg.random_mixed_kernel(a, 9),
                                      jdeg.random_mixed_kernel(b, 9))
        np.testing.assert_array_equal(deg.add_gaussian_noise(a, img),
                                      jdeg.add_gaussian_noise(b, img))
        pa, pb = deg.color_jitter_pair(a, img, img * 0.5)
        qa, qb = jdeg.color_jitter_pair(b, bgr, bgr * 0.5)
        np.testing.assert_array_equal(pa, qa[..., ::-1])
        np.testing.assert_array_equal(pb, qb[..., ::-1])
        _same_next_draw(a, b)
    np.testing.assert_array_equal(
        deg.bivariate_gaussian_kernel(11, 0.7, 0.3, 0.4),
        jdeg.bivariate_gaussian_kernel(11, 0.7, 0.3, 0.4))
    np.testing.assert_array_equal(deg.quantize_8bit(img),
                                  jdeg.quantize_8bit(img))
    gray = deg.to_gray3(img)
    assert gray.shape == img.shape and gray.dtype == np.float32
    assert np.abs(gray - jdeg.to_gray3(bgr)).max() <= 1e-7


@pytest.mark.parametrize("fn", ["jpeg_roundtrip", "blind_degrade"])
def test_jpeg_paths_raise_before_drawing(fn, cv2_own):
    """The JPEG paths draw what the JAX package's draw, in its order: the
    round trip bit-equal, the blind branch within the 8-bit rule of
    `_levels_close` (the port's float64 `filter2d` can flip a truncated
    uint8; tests/test_torch_jpeg.py states the share). Neither raises."""
    img = np.random.default_rng(7).uniform(0, 1, (40, 36, 3)).astype(
        np.float32)
    bgr = np.ascontiguousarray(img[..., ::-1])
    outs = []
    for seed in range(3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        got = getattr(deg, fn)(a, img)
        want = getattr(jdeg, fn)(b, bgr)[..., ::-1]
        assert got.shape == want.shape and got.dtype == np.float32
        if fn == "jpeg_roundtrip":
            np.testing.assert_array_equal(got, want)
        outs.append((got, want))
        _same_next_draw(a, b)
    _levels_close(np.stack([g for g, _ in outs]),
                  np.stack([w for _, w in outs]))


# -- the datasets -------------------------------------------------------------

ANGLES = ["11_0", "12_0", "09_0", "19_1", "08_1", "20_0", "01_0", "24_0",
          "08_0", "13_0", "14_0", "05_0", "04_1", "19_0", "05_1"]


def _write(path, img, how):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if how == "pil":
        Image.fromarray(img).save(path)
    elif how == "cv2":
        cv2.imwrite(path, img[..., ::-1])
    else:
        with open(path, "wb") as f:
            f.write(png_filtered(img))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A Multi-PIE tree as tests/test_data.py builds one (PIL-written, here
    at 80 x 80; train: 3 pids, test: 2; lights 00 and 01; patches on the
    frontal), its files written by PIL, cv2 and the filtered encoder in
    turn, and a flat CelebA-HQ directory of 96 x 96 PNGs."""
    root = tmp_path_factory.mktemp("mp")
    rng = np.random.default_rng(8)
    hows = ["pil", "cv2", "filtered"]
    i = 0
    for split, pids in (("train", ("p1", "p2", "p3")), ("test", ("q1", "q2"))):
        for pid in pids:
            for angle in ANGLES:
                for light in ("00", "01"):
                    names = [f"{light}.png"] + (
                        [f"{light}_patch.png"] if angle == "05_1" else [])
                    for name in names:
                        img = rng.integers(0, 256, (80, 80, 3), np.uint8)
                        _write(str(root / split / pid / angle / name), img,
                               hows[i % 3])
                        i += 1
    celeba = root / "celeba"
    for j in range(5):
        _write(str(celeba / f"{j:05d}.png"),
               rng.integers(0, 256, (96, 96, 3), np.uint8), hows[j % 3])
    (celeba / "notes.txt").write_text("not an image")
    return root


def _levels_close(got, want):
    """8-bit-quantised arrays: at most 1e-4 of the values one level apart,
    none more."""
    d = np.abs(np.rint(got * 255).astype(int) - np.rint(want * 255).astype(
        int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (d.max(),
                                                     (d > 0).mean())


@pytest.fixture
def cv2_own():
    """cv2's own resize algorithm for the JAX package's calls (IPP off)."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _compare(port_ds, jax_ds, atol=0.0):
    """Every key of every item of the two datasets, in order (the draws
    come in the same order): strings equal, arrays of the same dtype and
    shape within `atol` (0: bit-equal)."""
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        got, want = port_ds[i], jax_ds[i]
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, str):
                assert got[k] == v
                continue
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert np.abs(got[k] - v).max() <= atol, (i, k)


@pytest.mark.parametrize("joint_flip", [False, True])
def test_multipie_dataset(tree, cv2_own, joint_flip):
    kw = dict(split="train", model_type="uni", size=64, use_blind=False,
              use_patch=True, joint_flip=joint_flip, seed=3)
    _compare(multipie.MultiPIEDataset(str(tree), **kw),
             jmultipie.MultiPIEDataset(str(tree), **kw))


@pytest.mark.parametrize("model_type", ["e2m", "m2f", "e2f"])
def test_multipie_dataset_item_lists(tree, model_type):
    kw = dict(split="test", model_type=model_type, use_blind=False)
    assert (multipie.MultiPIEDataset(str(tree), **kw).items
            == jmultipie.MultiPIEDataset(str(tree), **kw).items)


def test_multipie_blind_branch_refused(tree, cv2_own):
    """The blind branch (the default, `use_blind=True`) is taken, not
    refused: the first 16 train items against the JAX class's, drawn in its
    order (the flips, `blind_degrade`, jitter, grey, the resizes; the next
    draw of both generators equal after every item): GT and patches
    bit-equal, LR within the 8-bit rule of `_levels_close` over all the
    items."""
    kw = dict(split="train", size=64, use_patch=True, seed=4)
    port = multipie.MultiPIEDataset(str(tree), **kw)
    ref = jmultipie.MultiPIEDataset(str(tree), **kw)
    assert port.items == ref.items and port.use_blind and not port.native
    lrs = []
    for i in range(16):
        got, want = port[i], ref[i]
        _same_next_draw(port._rng, ref._rng)
        assert set(got) == set(want) == {"lr", "gt", "patches"}
        np.testing.assert_array_equal(got["gt"], want["gt"])
        np.testing.assert_array_equal(got["patches"], want["patches"])
        assert got["lr"].shape == want["lr"].shape == (64, 64, 3)
        lrs.append((got["lr"], want["lr"]))
    _levels_close(np.stack([g for g, _ in lrs]),
                  np.stack([w for _, w in lrs]))


def test_multipie_single_view_and_inference(tree):
    _compare(multipie.MultiPIESingleViewDataset(str(tree), "19_1", size=64),
             jmultipie.MultiPIESingleViewDataset(str(tree), "19_1", size=64))
    _compare(multipie.MultiPIEInferenceDataset(str(tree), split="test",
                                               model_type="m2f", size=64),
             jmultipie.MultiPIEInferenceDataset(str(tree), split="test",
                                                model_type="m2f", size=64))


def test_multipie_idc_dataset(tree, cv2_own):
    port = multipie.MultiPIEIDCDataset(str(tree), size=64, seed=5)
    ref = jmultipie.MultiPIEIDCDataset(str(tree), size=64, seed=5)
    assert port.items == ref.items   # the negatives, drawn at construction
    _compare(port, ref)


def test_pretraining_datasets(tree):
    port = pretraining.MultiPIEHQDataset(str(tree), size=64)
    ref = jpretraining.MultiPIEHQDataset(str(tree), size=64)
    _compare(port, ref, atol=5e-7)   # cv2 as the JAX package runs it
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        _compare(port, ref)
    finally:
        cv2.ipp.setUseIPP(was)
    _compare(pretraining.CelebAHQDataset(str(tree / "celeba"), size=64),
             jpretraining.CelebAHQDataset(str(tree / "celeba"), size=64))
    assert pretraining.IMG_EXTS == jpretraining.IMG_EXTS


@pytest.mark.parametrize("ext", [".jpg", ".jpeg", ".webp", ".bmp", ".JPG"])
def test_celeba_refuses_what_it_cannot_decode(tmp_path, ext):
    """JPEG, BMP and WebP files are read (every item bit-equal to the JAX
    class's), an animated WebP file beside them as its first frame, as the
    JAX class reads it; a GIF file under the name, which the JAX class
    reads too, is refused when its item is read, naming the cause (GIF is
    not read yet)."""
    rng = np.random.default_rng(11)
    _write(str(tmp_path / "a.png"), rng.integers(0, 256, (40, 36, 3),
                                                 np.uint8), "pil")
    img = rng.integers(0, 256, (37, 45, 3), np.uint8)
    if ext.lower() in (".jpg", ".jpeg", ".bmp"):
        Image.fromarray(img).save(tmp_path / f"b{ext}", "JPEG" if ext.lower()
                                  != ".bmp" else "BMP", quality=90)
    else:
        cv2.imwrite(str(tmp_path / f"b{ext}"), img)
    _compare(pretraining.CelebAHQDataset(str(tmp_path), size=32),
             jpretraining.CelebAHQDataset(str(tmp_path), size=32))
    if ext == ".webp":
        Image.fromarray(img).save(tmp_path / "c.webp", "WEBP", lossless=True,
                                  save_all=True,
                                  append_images=[Image.fromarray(img[::-1])])
        _compare(pretraining.CelebAHQDataset(str(tmp_path), size=32),
                 jpretraining.CelebAHQDataset(str(tmp_path), size=32))
        Image.fromarray(img).save(tmp_path / "d.webp", "GIF")
        port = pretraining.CelebAHQDataset(str(tmp_path), size=32)
        with pytest.raises(ValueError, match="d.webp: a GIF file"):
            port[3]


def test_data_package_exports_as_jax():
    import hifidiff_tpu.data as jdata
    import hifidiff_tpu_torch.data as data

    assert set(jdata.__all__) <= set(data.__all__)


# -- ops/resize ---------------------------------------------------------------

@pytest.mark.parametrize("src, dst", [((16, 16), (32, 32)),
                                      ((32, 24), (8, 12)), ((7, 9), (7, 20))])
def test_resize_bicubic_torch(src, dst):
    import jax.numpy as jnp
    import torch.nn.functional as F

    from hifidiff_tpu.ops.resize import resize_bicubic_torch as jresize
    from hifidiff_tpu_torch.ops.resize import resize_bicubic_torch

    x = np.random.default_rng(9).normal(size=(2, 3, *src)).astype(np.float32)
    got = resize_bicubic_torch(torch.from_numpy(x), dst)
    ref = np.asarray(jresize(jnp.asarray(x.transpose(0, 2, 3, 1)), dst))
    lib = F.interpolate(torch.from_numpy(x), size=dst, mode="bicubic",
                        align_corners=False)
    assert got.shape == (2, 3, *dst)
    assert np.abs(got.numpy() - ref.transpose(0, 3, 1, 2)).max() <= 1e-5
    assert float((got - lib).abs().max()) <= 1e-5


# -- infer_cr -----------------------------------------------------------------

def test_infer_cr_against_jax(tmp_path, monkeypatch):
    """The port's CLI on a `.pt` file of a seeded, perturbed CR in the
    reference's names; the JAX CLI on the same weights through its
    importer (`load_cr` at these depths: its own reads `.pt` files only at
    the default depths, ROADMAP §C9); the same PNG (written by the
    filtered encoder, 50 x 45)."""
    from hifidiff_tpu.cli import infer_cr as jinfer
    from hifidiff_tpu.models import CoarseRestoration
    from hifidiff_tpu.utils import torch_import as ti
    from hifidiff_tpu_torch.cli import infer_cr
    from hifidiff_tpu_torch.cli.common import build_cr
    from hifidiff_tpu_torch.random_weights import perturb_

    monkeypatch.chdir(tmp_path)
    img = _face(np.random.default_rng(10), 50, 45)
    (tmp_path / "face.png").write_bytes(png_filtered(img))
    cr = build_cr(8, 32, "1,1", 1)
    perturb_(cr, torch.Generator().manual_seed(0))
    torch.save(cr.state_dict(), tmp_path / "cr.pt")
    sd = {k: v.numpy() for k, v in cr.state_dict().items()}
    monkeypatch.setattr(jinfer, "load_cr", lambda cfg, key: (
        CoarseRestoration(width=8, resolution=32, enc_nums=(1, 1),
                          mid_num=1, dec_nums=(2, 2)),
        ti.cr_params(sd, (1, 1), 1, (2, 2))))
    argv = ["--size", "32", "--width", "8", "--enc-depths", "1,1",
            "--mid-depth", "1", "--image", "face.png", "--ckpt", "cr.pt"]
    jinfer.main(argv + ["--output", "jax.png"])
    out = infer_cr.main(argv + ["--output", "port.png", "--device", "cpu"])
    assert out.shape == (1, 32, 32, 3)
    want = np.asarray(Image.open(tmp_path / "jax.png").convert("RGB"))
    got = image_io.imread_rgb(str(tmp_path / "port.png"))
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_infer_cr_refuses_kface_and_needs_an_image(tmp_path):
    """`--dataroot` reads a K-Face split (here one that is not there: the
    split's directory is named), and without `--image` or `--dataroot` the
    CLI asks for one (the runs: tests/test_torch_kface.py)."""
    from hifidiff_tpu_torch.cli import infer_cr

    with pytest.raises(FileNotFoundError, match="val"):
        infer_cr.main(["--dataroot", str(tmp_path), "--device", "cpu",
                       "--width", "8", "--enc-depths", "1,1",
                       "--mid-depth", "1", "--size", "32"])
    with pytest.raises(ValueError, match="--image"):
        infer_cr.main(["--device", "cpu"])


# -- the procedural faces' LR protocol ----------------------------------------

def test_procedural_lr_at_128_px():
    """`degrade_lr` at 128 px against the same protocol through
    `cv2.resize` (the JAX package's `_resize`), over 8 faces of both
    families."""
    from hifidiff_tpu.data import procedural as jproc
    from hifidiff_tpu_torch.data import procedural

    assert jproc.cv2 is not None   # the JAX module takes its cv2 branch
    for spread in (1.0, 0.3):
        ds = procedural.ProceduralFaceDataset(8, 128, keys=("lr", "gt"),
                                              id_spread=spread)
        ref = jproc.ProceduralFaceDataset(8, 128, keys=("lr", "gt"),
                                          id_spread=spread)
        for i in range(len(ds)):
            got, want = ds[i], ref[i]
            np.testing.assert_array_equal(got["gt"], want["gt"])
            _levels_close(got["lr"], want["lr"])
