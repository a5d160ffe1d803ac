"""The datasets and `infer_cr` on files of the formats the port's decoders
gained (progressive JPEG, Adam7-interlaced and 16-bit PNG, BMP), against
the JAX package's classes and CLI, which read them with PIL and cv2, on
the CPU at small sizes.

Tolerances, as tests/test_torch_data.py's: every key of every item
bit-equal to the JAX class's, with cv2's IPP off (cv2's own resize
algorithm) for the classes that resize with cv2; `infer_cr`'s saved grid
within one uint8 level of the JAX CLI's on the same weights.
"""

import io
import os
import pathlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from hifidiff_tpu.data import kface as jkface  # noqa: E402
from hifidiff_tpu.data import multipie as jmultipie  # noqa: E402
from hifidiff_tpu.data import pretraining as jpretraining  # noqa: E402
from hifidiff_tpu_torch.data import (image_io, kface, multipie,  # noqa: E402
                                     pretraining)
from hifidiff_tpu_torch.data.image_files import bmp_file, png_file  # noqa: E402,E501

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
ANGLES = ("11_0", "12_0", "09_0", "19_1", "08_1", "20_0", "01_0", "24_0",
          "08_0", "13_0", "14_0", "05_0", "04_1", "19_0", "05_1")


def _progressive(img, quality=90):
    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", quality=quality, progressive=True)
    return out.getvalue()


def _sixteen(img8, rng):
    """An 8-bit image widened to 16 bits with random low bytes."""
    return img8.astype(np.int64) * 256 + rng.integers(0, 256, img8.shape)


def _formats(rng, h, w):
    """One image in each new format (the bytes of a file), from a seeded
    random RGB image: Adam7 8-bit RGB, Adam7 16-bit RGB, 16-bit grey
    (Adam7 and not), 16-bit grey + alpha, 16-bit RGBA, progressive JPEG and
    BMP (24-bit, 8-bit palette, RLE8)."""
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    grey = img[..., :1]
    alpha = rng.integers(0, 256, (h, w, 1), np.uint8)
    idx = rng.integers(0, 40, (h, w))
    idx[:, ::3] = idx[:, :1]           # runs for the RLE encoder
    palette = rng.integers(0, 256, (40, 3))
    return [
        png_file(img, 8, 2, 1),
        png_file(_sixteen(img, rng), 16, 2, 1),
        png_file(_sixteen(grey, rng), 16, 0, 1),
        png_file(_sixteen(grey, rng), 16, 0, 0),
        png_file(_sixteen(np.concatenate([grey, alpha], -1), rng), 16, 4),
        png_file(_sixteen(np.concatenate([img, alpha], -1), rng), 16, 6,
                    1),
        _progressive(img),
        bmp_file(img, 24),
        bmp_file(idx, 8, palette=palette),
        bmp_file(idx, 8, palette=palette, rle=True),
    ]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A Multi-PIE tree (train: 2 pids, test: 2; lights 00 and 01; patches
    on the frontal; 72 x 64) whose `.png` paths hold the new formats in
    turn (cv2 and PIL read a file by its bytes, not its name), and a flat
    CelebA-HQ directory of every format under its own extension."""
    root = tmp_path_factory.mktemp("formats")
    rng = np.random.default_rng(15)
    i = 0
    for split, pids in (("train", ("p1", "p2")), ("test", ("q1", "q2"))):
        for pid in pids:
            for angle in ANGLES:
                for light in ("00", "01"):
                    names = [f"{light}.png"] + (
                        [f"{light}_patch.png"] if angle == "05_1" else [])
                    for name in names:
                        files = _formats(rng, 72, 64)
                        path = root / split / pid / angle / name
                        path.parent.mkdir(parents=True, exist_ok=True)
                        path.write_bytes(files[i % len(files)])
                        i += 1
    celeba = root / "celeba"
    celeba.mkdir()
    for j, data in enumerate(_formats(rng, 50, 44)):
        ext = {b"\x89P": ".png", b"\xff\xd8": ".jpg", b"BM": ".bmp"}[data[:2]]
        (celeba / f"{j:05d}{ext}").write_bytes(data)
    return root


@pytest.fixture
def cv2_own():
    """cv2's own resize algorithm for the JAX package's calls (IPP off)."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _compare(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        got, want = port_ds[i], jax_ds[i]
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, str):
                assert got[k] == v
                continue
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert got[k].tobytes() == v.tobytes(), (i, k, np.abs(
                got[k].astype(float) - v).max())


def test_the_tree_holds_every_format(tree):
    heads = {p.read_bytes()[:2] for p in tree.rglob("*.png")}
    assert heads == {b"\x89P", b"\xff\xd8", b"BM"}
    depths = {p.read_bytes()[24] for p in tree.rglob("*.png")
              if p.read_bytes()[:2] == b"\x89P"}
    assert depths == {8, 16}


def test_multipie_cv2_and_pil_sites(tree, cv2_own):
    """`MultiPIEDataset` reads input and GT as cv2 does and the patch as
    PIL does; the single-view and inference sets read as PIL does; the IDC
    set as cv2 does."""
    kw = dict(split="train", model_type="uni", size=64, use_blind=False,
              use_patch=True, seed=3)
    _compare(multipie.MultiPIEDataset(str(tree), **kw),
             jmultipie.MultiPIEDataset(str(tree), **kw))
    for angle in ("11_0", "19_0"):
        _compare(multipie.MultiPIESingleViewDataset(
            str(tree), angle, split="test", size=64),
            jmultipie.MultiPIESingleViewDataset(str(tree), angle,
                                                split="test", size=64))
    _compare(multipie.MultiPIEInferenceDataset(str(tree), split="test",
                                               model_type="m2f", size=64),
             jmultipie.MultiPIEInferenceDataset(str(tree), split="test",
                                                model_type="m2f", size=64))
    _compare(multipie.MultiPIEIDCDataset(str(tree), size=64, seed=5),
             jmultipie.MultiPIEIDCDataset(str(tree), size=64, seed=5))


def test_pretraining_datasets(tree, cv2_own):
    """Multi-PIE HQ reads as cv2 does, CelebA-HQ as PIL does, on every
    format; a 16-bit grey file reads differently in the two (PIL clamps,
    cv2 keeps the high byte), and each follows its own library."""
    _compare(pretraining.MultiPIEHQDataset(str(tree), size=64),
             jpretraining.MultiPIEHQDataset(str(tree), size=64))
    celeba = str(tree / "celeba")
    _compare(pretraining.CelebAHQDataset(celeba, size=32),
             jpretraining.CelebAHQDataset(celeba, size=32))
    grey16 = next(p for p in sorted((tree / "celeba").iterdir())
                  if p.read_bytes()[24:26] == b"\x10\x00")
    pil = image_io.imread_rgb(str(grey16), reader="pil")
    ocv = image_io.imread_rgb(str(grey16), reader="cv2")
    np.testing.assert_array_equal(
        pil, np.asarray(Image.open(grey16).convert("RGB")))
    np.testing.assert_array_equal(ocv, cv2.imread(str(grey16))[..., ::-1])
    assert not np.array_equal(pil, ocv)


def test_kface_progressive_jpeg(tmp_path):
    """The K-Face sets on a tree of progressive JPEGs (one id, two lights,
    three expressions, the 20 angles, 64 x 64), head boxes inside and past
    the edge."""
    rng = np.random.default_rng(21)
    for light, expr in ((li, e) for li in ("L1", "L3")
                        for e in ("E01", "E02", "E03")):
        base = tmp_path / "train" / "k1" / "S001" / light / expr
        base.mkdir(parents=True)
        for angle in range(1, 21):
            img = rng.integers(0, 256, (64, 64, 3), np.uint8)
            (base / f"C{angle}.jpg").write_bytes(_progressive(img, 85))
            head = "-4\t-2\t56\t60" if angle == 1 else "8\t6\t48\t50"
            (base / f"C{angle}.txt").write_text("\n".join(
                ["x"] * 7 + [head] + ["20\t20\t16\t16"] * 4))
    for port, ref in (
            (kface.KFaceDataset(str(tmp_path), "train", size=64),
             jkface.KFaceDataset(str(tmp_path), "train", size=64)),
            (kface.KFaceHRDataset(str(tmp_path), size=32),
             jkface.KFaceHRDataset(str(tmp_path), size=32))):
        assert port.items == ref.items
        _compare(port, ref)


@pytest.fixture(scope="module")
def cr_files(tmp_path_factory):
    """A seeded, perturbed tiny CR as a `.pt` file, and the JAX CLI's
    `load_cr` on the same weights."""
    from hifidiff_tpu.models import CoarseRestoration
    from hifidiff_tpu.utils import torch_import as ti
    from hifidiff_tpu_torch.cli.common import build_cr
    from hifidiff_tpu_torch.random_weights import perturb_

    tmp = tmp_path_factory.mktemp("cr")
    cr = build_cr(8, 32, "1,1", 1)
    perturb_(cr, torch.Generator().manual_seed(0))
    torch.save(cr.state_dict(), tmp / "cr.pt")
    sd = {k: v.numpy() for k, v in cr.state_dict().items()}
    jax_cr = (CoarseRestoration(width=8, resolution=32, enc_nums=(1, 1),
                                mid_num=1, dec_nums=(2, 2)),
              ti.cr_params(sd, (1, 1), 1, (2, 2)))
    return tmp / "cr.pt", jax_cr


@pytest.mark.parametrize("kind", ["progressive.jpg", "adam7_16bit.png",
                                  "grey16.png", "palette.bmp", "rle8.bmp",
                                  "lossy.webp", "lossless.webp", "cmyk.jpg",
                                  "animated.webp"])
def test_infer_cr_image_against_jax(tmp_path, monkeypatch, cr_files, kind):
    """`infer_cr --image` on each new format against the JAX CLI (PIL's
    read), the same weights: the LR input bit-equal, the saved grids
    within one level."""
    from hifidiff_tpu.cli import infer_cr as jinfer
    from hifidiff_tpu_torch.cli import infer_cr

    ckpt, jax_cr = cr_files
    rng = np.random.default_rng(len(kind))
    files = dict(zip(["adam7_16bit.png", "grey16.png", "progressive.jpg",
                      "palette.bmp", "rle8.bmp"],
                     [_formats(rng, 47, 53)[k] for k in (1, 2, 6, 8, 9)]))
    for name, opts in (("lossy.webp", dict(quality=80)),
                       ("lossless.webp", dict(lossless=True)),
                       ("animated.webp", dict(quality=80, save_all=True)),
                       ("cmyk.jpg", dict(quality=90))):
        buf = io.BytesIO()
        img = Image.fromarray(rng.integers(0, 256, (47, 53, 3), np.uint8))
        if name == "cmyk.jpg":
            img.convert("CMYK").save(buf, "JPEG", **opts)
        else:
            if name == "animated.webp":
                opts["append_images"] = [img.transpose(0)]
            img.save(buf, "WEBP", **opts)
        files[name] = buf.getvalue()
    (tmp_path / kind).write_bytes(files[kind])
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jinfer, "load_cr", lambda cfg, key: jax_cr)
    argv = ["--size", "32", "--width", "8", "--enc-depths", "1,1",
            "--mid-depth", "1", "--image", kind, "--ckpt", str(ckpt)]
    bic = Image.Resampling.BICUBIC
    want_lr = np.asarray(Image.open(kind).convert("RGB").resize(
        (32, 32), bic).resize((32, 32), bic), np.float32) / 255.0
    np.testing.assert_array_equal(infer_cr.lr_input(kind, 32)[0], want_lr)
    jinfer.main(argv + ["--output", "jax.png"])
    infer_cr.main(argv + ["--output", "port.png", "--device", "cpu"])
    want = np.asarray(Image.open("jax.png").convert("RGB")).astype(int)
    got = image_io.imread_rgb("port.png").astype(int)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1
    assert os.path.getsize("port.png") > 0
