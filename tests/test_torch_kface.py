"""The K-Face datasets and the CLIs that the JPEG codec unblocks, on the CPU
at small sizes.

  * the six K-Face classes of `data/kface.py` against the JAX package's on
    the JAX tests' trees (`tests/test_data.py`, PIL-written, 160 x 160:
    `make_kface_tree`, `make_kface_crop_tree`; ten ids for the raw IDC
    class, 21 for the cropped one) and on a small tree whose head boxes run
    past the image and whose component boxes lie left of and above the
    head (the mask slices then start negative): the item lists equal, in
    `os.listdir` order, and every key of the items compared bit-equal;
  * `--dataroot` of the five training CLIs whose Multi-PIE train split takes
    the blind branch (`train_cr`, `train_refiner`, `train_tiny_cr`,
    `train_tiny_dn`, `distill`), one step each on a two-item tree; of
    `test_refiner` (the K-Face val split), `test_idc` (the test split's
    triplets) and `infer_cr` (a split, and `--image` on a JPEG), one batch
    each; all with `--device cpu` at the tiny sizes of
    `tests/torch_parity.TINY_CLI`: finite results of the expected shapes.
"""

import dataclasses
import importlib
import json
import math
import os

import numpy as np
import pytest
import torch

pytest.importorskip("PIL.Image")

from hifidiff_tpu.data import kface as jkface  # noqa: E402
from hifidiff_tpu_torch.data import kface  # noqa: E402
from hifidiff_tpu_torch.data.jpeg import encode_jpeg  # noqa: E402
from test_data import make_kface_crop_tree, make_kface_tree  # noqa: E402
from torch_parity import TINY_CLI, cli_flags  # noqa: E402

torch.set_num_threads(1)


def _compare(port_ds, jax_ds, stride=1):
    assert port_ds.items == jax_ds.items
    assert len(port_ds) > 0
    for i in range(0, len(jax_ds), stride):
        got, want = port_ds[i], jax_ds[i]
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=f"{i} {k}")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("kface")
    make_kface_tree(str(root / "raw"))
    make_kface_tree(str(root / "raw10"), split="test",
                    ids=tuple(f"id{i:02d}" for i in range(10)))
    make_kface_crop_tree(str(root / "crop"))
    make_kface_crop_tree(str(root / "crop21"),
                         ids=tuple(f"p{i:02d}" for i in range(21)),
                         with_patches=False)
    return root


@pytest.fixture(scope="module")
def edge_tree(tmp_path_factory):
    """One id, 48 x 48 files written by the port's encoder; angle 1's head
    box runs past the left and top edges, angle 20's past the right and
    bottom, the rest inside; two component boxes lie left of and above the
    head box."""
    root = tmp_path_factory.mktemp("kface_edge")
    rng = np.random.default_rng(30)
    for light in ("L1", "L3"):
        for expr in ("E01", "E02", "E03"):
            base = root / "train" / "e1" / "S001" / light / expr
            base.mkdir(parents=True)
            for angle in range(1, 21):
                img = rng.integers(0, 256, (48, 48, 3), np.uint8)
                (base / f"C{angle}.jpg").write_bytes(encode_jpeg(img, 90))
                head = {1: "-5\t-3\t40\t44", 20: "12\t10\t44\t46"}.get(
                    angle, "4\t4\t40\t40")
                comps = ["2\t1\t10\t8", "20\t12\t9\t9", "14\t22\t12\t8",
                         "10\t30\t20\t7"]
                (base / f"C{angle}.txt").write_text(
                    "\n".join(["x"] * 7 + [head] + comps))
    return root


def test_kface_dataset(trees, edge_tree):
    _compare(kface.KFaceDataset(str(trees / "raw"), "train"),
             jkface.KFaceDataset(str(trees / "raw"), "train"), stride=7)
    _compare(kface.KFaceDataset(str(edge_tree), "train", size=64),
             jkface.KFaceDataset(str(edge_tree), "train", size=64))


def test_kface_crop_dataset(trees):
    _compare(kface.KFaceCropDataset(str(trees / "crop"), "train"),
             jkface.KFaceCropDataset(str(trees / "crop"), "train"), stride=3)
    _compare(kface.KFaceCropDataset(str(trees / "crop"), "train", size=64,
                                    include_patches=False),
             jkface.KFaceCropDataset(str(trees / "crop"), "train", size=64,
                                     include_patches=False), stride=5)


@pytest.mark.parametrize("seed", [0, 3])
def test_kface_idc_dataset(trees, seed):
    """Ten ids: the fewest for which the 19-id window yields items."""
    port = kface.KFaceIDCDataset(str(trees / "raw10"), "test", seed=seed)
    assert len(port) == 2 * 3 * 19
    _compare(port, jkface.KFaceIDCDataset(str(trees / "raw10"), "test",
                                          seed=seed), stride=19)


@pytest.mark.parametrize("seed", [0, 3])
def test_kface_crop_idc_dataset(trees, seed):
    _compare(kface.KFaceCropIDCDataset(str(trees / "crop21"), "train",
                                       seed=seed, size=64),
             jkface.KFaceCropIDCDataset(str(trees / "crop21"), "train",
                                        seed=seed, size=64), stride=17)


def test_kface_hr_datasets(trees, edge_tree):
    _compare(kface.KFaceHRDataset(str(trees / "raw"), size=64),
             jkface.KFaceHRDataset(str(trees / "raw"), size=64), stride=11)
    _compare(kface.KFaceHRDataset(str(edge_tree), size=32),
             jkface.KFaceHRDataset(str(edge_tree), size=32))
    _compare(kface.KFaceCropHRDataset(str(trees / "crop"), size=64),
             jkface.KFaceCropHRDataset(str(trees / "crop"), size=64),
             stride=4)


def test_kface_constants_and_crop():
    for name in ("LIGHT_CONDITIONS", "CROP_LIGHT_CONDITIONS", "EXPRESSIONS",
                 "NUM_ANGLES", "FRONTAL_ANGLE"):
        assert getattr(kface, name) == getattr(jkface, name)
    from PIL import Image

    img = np.random.default_rng(31).integers(0, 256, (9, 11, 3), np.uint8)
    for box in ((-3, -2, 5, 6), (4, 5, 15, 12), (-2, -2, 14, 12),
                (2, 3, 7, 8)):
        np.testing.assert_array_equal(
            kface._crop(img, *box), np.asarray(Image.fromarray(img).crop(
                box)))


# -- the CLIs --------------------------------------------------------------

ANGLES = ("11_0", "19_0")   # two input angles; the frontal GT is 05_1


@pytest.fixture(scope="module")
def data_trees(tmp_path_factory):
    """A Multi-PIE tree of two items a split (48 x 48 PNGs with the
    frontal's patch image) and a K-Face tree (val: 1 id, test: 10 ids;
    40 x 40 JPEGs with metadata) for the CLIs."""
    from hifidiff_tpu_torch.utils.logging import png_bytes

    root = tmp_path_factory.mktemp("cli_data")
    rng = np.random.default_rng(32)
    for split in ("train", "test"):
        for angle in (*ANGLES, "05_1"):
            d = root / "mp" / split / "p1" / angle
            d.mkdir(parents=True)
            names = ["00.png"] + (["00_patch.png"] if angle == "05_1"
                                  else [])
            for name in names:
                (d / name).write_bytes(png_bytes(rng.integers(
                    0, 256, (48, 48, 3), np.uint8)))
    meta = "\n".join(["x"] * 7 + ["2\t2\t36\t36"] + ["10\t12\t8\t6"] * 4)
    for split, ids in (("val", 1), ("test", 10)):
        for i in range(ids):
            for light in ("L1", "L3"):
                for expr in ("E01", "E02", "E03"):
                    d = root / "kface" / split / f"k{i:02d}" / "S001" / \
                        light / expr
                    d.mkdir(parents=True)
                    for angle in range(1, 21):
                        (d / f"C{angle}.jpg").write_bytes(encode_jpeg(
                            rng.integers(0, 256, (40, 40, 3), np.uint8), 90))
                        (d / f"C{angle}.txt").write_text(meta)
    return root


def _flags(cli, tmp, **more):
    """TINY_CLI sizes, batch 2, one epoch, on the CPU, for the fields the
    CLI has; `more` on top."""
    fields = {f.name for f in dataclasses.fields(cli.Config)}
    kw = dict(TINY_CLI, batch_size=2, num_epochs=1, seed=0, device="cpu",
              name="t", log_dir=tmp / "logs", ckpt_dir=tmp / "ckpt",
              out_dir=tmp / "img", tiny_width=8, tiny_blocks=1,
              dump_every=0, save_epoch=1, num_inference_steps=2)
    if cli.__name__.endswith("train_cr") or cli.__name__.endswith(
            "infer_cr"):
        kw.update(width=8, enc_depths="1,1", mid_depth=1)
    kw.update(more)
    return cli_flags(**{k: v for k, v in kw.items() if k in fields})


def _log_rows(tmp, project):
    with open(tmp / "logs" / f"{project}.t.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name, project, more", [
    ("train_cr", "hifi_cr", {}),
    ("train_refiner", "hifi_refiner", {}),
    ("train_tiny_cr", "hifi_tiny_cr", {}),
    ("train_tiny_dn", "hifi_tiny_dn", dict(rollout_steps=1)),
    ("distill", "hifi_distill", dict(teacher_steps=2, student_steps="1",
                                     steps_per_round=1, eval_batch=2)),
])
def test_blind_training_clis_take_dataroot(data_trees, tmp_path, name,
                                           project, more):
    """One step on the two-item Multi-PIE tree through the blind branch:
    the logged values finite."""
    cli = importlib.import_module(f"hifidiff_tpu_torch.cli.{name}")
    result = cli.main(_flags(cli, tmp_path, dataroot=data_trees / "mp",
                             **more))
    rows = _log_rows(tmp_path, project)
    assert rows and all(math.isfinite(v) for r in rows for v in r.values()
                        if isinstance(v, (int, float)))
    if name == "distill":
        assert all(np.isfinite(v) for r in result["rounds"]
                   for v in r.values())


def test_test_refiner_and_test_idc_take_dataroot(data_trees, tmp_path):
    from hifidiff_tpu_torch.cli import test_idc, test_refiner

    out = test_refiner.main(_flags(test_refiner, tmp_path,
                                   dataroot=data_trees / "kface",
                                   batch_size=114, grid_every=1))
    assert set(out) == {"psnr", "ssim"}
    assert all(np.isfinite(v) for v in out.values())
    assert sorted(os.listdir(tmp_path / "img")) == ["batch_0.png"]
    acc = test_idc.main(_flags(test_idc, tmp_path,
                               dataroot=data_trees / "kface",
                               batch_size=114))
    assert acc["batch_accuracy"] in (0.0, 1.0)
    assert 0 <= acc["sample_accuracy"] <= 1


def test_infer_cr_takes_dataroot_and_jpeg(data_trees, tmp_path):
    from hifidiff_tpu_torch.cli import infer_cr

    faces = infer_cr.main(_flags(infer_cr, tmp_path,
                                 dataroot=data_trees / "kface",
                                 batch_size=64))
    assert faces.shape == (114, 32, 32, 3) and np.isfinite(faces).all()
    assert sorted(os.listdir(tmp_path / "img")) == ["batch_0.png",
                                                    "batch_1.png"]
    image = data_trees / "kface" / "val" / "k00" / "S001" / "L1" / "E01"
    one = infer_cr.main(_flags(infer_cr, tmp_path, image=image / "C3.jpg",
                               output=tmp_path / "one.png"))
    assert one.shape == (1, 32, 32, 3) and np.isfinite(one).all()
    assert (tmp_path / "one.png").exists()
