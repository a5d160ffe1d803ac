"""K-Face datasets (counterpart of hifidiff_tpu/data/kface.py; NHWC numpy,
the same `split=` API, constants, item lists and outputs).

Semantics mirror the reference (`dataset_kface.py`):
  * directory layout `<root>/<split>/<id>/S001/<light>/<expr>/C<angle>.jpg`
    (+ `.txt` metadata for the un-cropped variants); angle C7 is the frontal
    GT repeated for the other 19 angles.
  * LR protocol: crop by head bbox (meta line 8), PIL bicubic to 32x32 then
    back to `size` (`dataset_kface.py:88-91`).
  * key-region patches: 4 binary bbox masks (eye_r/eye_l/nose/mouth, meta
    lines 9-12, offset by the head bbox) multiplied into the GT
    (`get_masked_patches`, `dataset_kface.py:15-37`), stacked on a leading
    patch axis -> (P, H, W, C) here.
  * IDC triplet variants pick the negative by a shifted id-index window
    (`dataset_kface.py:227-246,323-333`).
  * Crop variants read pre-cropped files, 8 light conditions, patches from
    pre-rendered `C<angle>_<0..7>.jpg` files.

The files are read by the port's decoders (`image_io.imread_rgb`, with
`reader="pil"`), which give what PIL's `convert("RGB")` gives; PIL's
crop and resizes are `_crop` and `resize.resize_pil`. The JAX module's
quirks are kept: items follow `os.listdir` order (not sorted) but in the
IDC classes, which sort, shuffle with `default_rng(seed)` and wrap a 19-id
window; a crop past the image fills with zeros; `masked_patches` slices the
mask with offsets that can go negative, which numpy reads from the end.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from hifidiff_tpu_torch.data.core import Dataset, Sample
from hifidiff_tpu_torch.data.image_io import imread_rgb
from hifidiff_tpu_torch.data.resize import resize_pil

LIGHT_CONDITIONS = ["L1", "L3"]
CROP_LIGHT_CONDITIONS = ["L1", "L2", "L3", "L4", "L8", "L9", "L10", "L13"]
EXPRESSIONS = ["E01", "E02", "E03"]
NUM_ANGLES = 20
FRONTAL_ANGLE = 7


def _to_float(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 255.0


def _bicubic(img: np.ndarray, size: int) -> np.ndarray:
    return resize_pil(img, (size, size), "bicubic")


def _lr_protocol(img: np.ndarray, size: int = 128) -> np.ndarray:
    return _to_float(_bicubic(_bicubic(img, 32), size))


def _read_meta(path: str) -> List[str]:
    with open(path) as f:
        return f.readlines()


def _bbox(meta_line: str):
    left, top, width, height = map(int, meta_line.split("\t"))
    return left, top, width, height


def _crop(img: np.ndarray, left: int, top: int, right: int,
          bottom: int) -> np.ndarray:
    """PIL's `Image.crop((left, top, right, bottom))`: what lies outside
    the image is zeros."""
    h, w = img.shape[:2]
    out = np.zeros((max(0, bottom - top), max(0, right - left))
                   + img.shape[2:], img.dtype)
    y0, y1 = max(top, 0), min(bottom, h)
    x0, x1 = max(left, 0), min(right, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


def _crop_by_head(img: np.ndarray, meta: List[str]) -> np.ndarray:
    left, top, w, h = _bbox(meta[7])
    return _crop(img, left, top, left + w, top + h)


def masked_patches(gt: np.ndarray, meta: List[str],
                   size: int = 128) -> np.ndarray:
    """(4, size, size, 3) facial-component patch images of the uint8 GT."""
    head_left, head_top, _, _ = _bbox(meta[7])
    gh, gw = gt.shape[:2]
    patches = []
    for line in meta[8:12]:
        left, top, w, h = _bbox(line)
        mask = np.zeros((gh, gw), dtype=np.uint8)
        mask[top - head_top:top + h - head_top,
             left - head_left:left + w - head_left] = 1
        mask = resize_pil(mask, (size, size), "nearest")
        patch = gt * mask[..., None]
        patches.append(patch.astype(np.float32) / 255.0)
    return np.stack(patches)


def _kface_pairs(root: str, lights: List[str]):
    """Yield (input_img, input_meta, gt_img, gt_meta) path tuples."""
    for pid in os.listdir(root):
        for light in lights:
            for expr in EXPRESSIONS:
                base = os.path.join(root, pid, "S001", light, expr)
                gt_img = os.path.join(base, f"C{FRONTAL_ANGLE}.jpg")
                gt_meta = os.path.join(base, f"C{FRONTAL_ANGLE}.txt")
                for angle in range(1, NUM_ANGLES + 1):
                    if angle == FRONTAL_ANGLE:
                        continue
                    yield (os.path.join(base, f"C{angle}.jpg"),
                           os.path.join(base, f"C{angle}.txt"),
                           gt_img, gt_meta)


class KFaceDataset(Dataset):
    """(lr, gt, patches) triples from raw K-Face with metadata crops."""

    def __init__(self, root: str, split: str = "train", size: int = 128):
        self.size = size
        self.items = list(_kface_pairs(os.path.join(root, split),
                                       LIGHT_CONDITIONS))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Sample:
        in_img, in_meta, gt_img, gt_meta = self.items[index]
        meta_in = _read_meta(in_meta)
        meta_gt = _read_meta(gt_meta)
        lr = _lr_protocol(_crop_by_head(imread_rgb(in_img, reader="pil"),
                                        meta_in),
                          self.size)
        gt = _bicubic(_crop_by_head(imread_rgb(gt_img, reader="pil"),
                                    meta_gt), self.size)
        return {
            "lr": lr,
            "gt": _to_float(gt),
            "patches": masked_patches(gt, meta_gt, self.size),
        }


class KFaceCropDataset(Dataset):
    """Pre-cropped K-Face; patches read from `C<angle>_<k>.jpg` renders."""

    def __init__(self, root: str, split: str = "train", size: int = 128,
                 include_patches: bool = True):
        self.size = size
        self.include_patches = include_patches
        self.items = []
        split_root = os.path.join(root, split)
        for pid in os.listdir(split_root):
            for light in CROP_LIGHT_CONDITIONS:
                for expr in EXPRESSIONS:
                    base = os.path.join(split_root, pid, "S001", light, expr)
                    gt = os.path.join(base, f"C{FRONTAL_ANGLE}.jpg")
                    if not os.path.exists(gt):
                        continue
                    for angle in range(1, NUM_ANGLES + 1):
                        if angle == FRONTAL_ANGLE:
                            continue
                        img = os.path.join(base, f"C{angle}.jpg")
                        if os.path.exists(img):
                            patch_paths = [
                                os.path.join(base, f"C{angle}_{k}.jpg")
                                for k in range(8)]
                            self.items.append((img, gt, patch_paths))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Sample:
        img, gt, patch_paths = self.items[index]
        out: Sample = {
            "lr": _lr_protocol(imread_rgb(img, reader="pil"), self.size),
            "gt": _to_float(_bicubic(imread_rgb(gt, reader="pil"),
                                     self.size)),
        }
        if self.include_patches:
            out["patches"] = np.stack([
                _to_float(imread_rgb(p, reader="pil"))
                for p in patch_paths])
        return out


class KFaceIDCDataset(Dataset):
    """Triplets for IDC pretraining: (lr of person i, frontal GT of person i,
    frontal of a different person), negatives from a shifted 19-id window."""

    def __init__(self, root: str, split: str = "train", size: int = 128,
                 seed: int = 0):
        self.size = size
        split_root = os.path.join(root, split)
        ids = sorted(os.listdir(split_root))
        rng = np.random.default_rng(seed)
        rng.shuffle(ids)
        ids = ids + ids[:19]  # wrap the last window

        self.items = []
        for idx in range(len(ids) - 19):
            for light in LIGHT_CONDITIONS:
                for expr in EXPRESSIONS:
                    base = os.path.join(split_root, ids[idx], "S001", light,
                                        expr)
                    gt = (os.path.join(base, f"C{FRONTAL_ANGLE}.jpg"),
                          os.path.join(base, f"C{FRONTAL_ANGLE}.txt"))
                    others = []
                    for j in range(idx + 1, idx + 20):
                        ob = os.path.join(split_root, ids[j], "S001", light,
                                          expr)
                        others.append(
                            (os.path.join(ob, f"C{FRONTAL_ANGLE}.jpg"),
                             os.path.join(ob, f"C{FRONTAL_ANGLE}.txt")))
                    k = 0
                    for angle in range(1, NUM_ANGLES + 1):
                        if angle == FRONTAL_ANGLE:
                            continue
                        inp = (os.path.join(base, f"C{angle}.jpg"),
                               os.path.join(base, f"C{angle}.txt"))
                        self.items.append((inp, gt, others[k]))
                        k += 1

    def __len__(self):
        return len(self.items)

    def _load(self, img_meta, lr: bool) -> np.ndarray:
        img_path, meta_path = img_meta
        img = _crop_by_head(imread_rgb(img_path, reader="pil"),
                            _read_meta(meta_path))
        if lr:
            return _lr_protocol(img, self.size)
        return _to_float(_bicubic(img, self.size))

    def __getitem__(self, index: int) -> Sample:
        inp, gt, other = self.items[index]
        return {"lr": self._load(inp, lr=True),
                "gt": self._load(gt, lr=False),
                "other": self._load(other, lr=False)}


class KFaceCropIDCDataset(Dataset):
    """Triplets from the pre-cropped layout (negatives windowed by the
    per-condition cropped count, `dataset_kface.py:323-333`)."""

    def __init__(self, root: str, split: str = "train", size: int = 128,
                 seed: int = 0):
        self.size = size
        split_root = os.path.join(root, split)
        ids = sorted(os.listdir(split_root))
        rng = np.random.default_rng(seed)
        rng.shuffle(ids)
        ids = ids + ids[:19]

        self.items = []
        for idx in range(len(ids) - 19):
            for light in CROP_LIGHT_CONDITIONS:
                for expr in EXPRESSIONS:
                    base = os.path.join(split_root, ids[idx], "S001", light,
                                        expr)
                    gt = os.path.join(base, f"C{FRONTAL_ANGLE}.jpg")
                    if not os.path.exists(gt):
                        continue
                    inputs = []
                    for angle in range(1, NUM_ANGLES + 1):
                        if angle == FRONTAL_ANGLE:
                            continue
                        p = os.path.join(base, f"C{angle}.jpg")
                        if os.path.exists(p):
                            inputs.append(p)
                    for k, inp in enumerate(inputs):
                        ob = os.path.join(split_root, ids[idx + 1 + k],
                                          "S001", light, expr)
                        self.items.append(
                            (inp, gt,
                             os.path.join(ob, f"C{FRONTAL_ANGLE}.jpg")))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Sample:
        inp, gt, other = self.items[index]
        return {
            "lr": _lr_protocol(imread_rgb(inp, reader="pil"), self.size),
            "gt": _to_float(_bicubic(imread_rgb(gt, reader="pil"),
                                     self.size)),
            "other": _to_float(_bicubic(imread_rgb(other, reader="pil"),
                                        self.size)),
        }


class KFaceHRDataset(Dataset):
    """HQ crops for unconditional denoiser pretraining (all angles)."""

    def __init__(self, root: str, split: str = "train", size: int = 128):
        self.size = size
        self.items = []
        split_root = os.path.join(root, split)
        for pid in os.listdir(split_root):
            for light in LIGHT_CONDITIONS:
                for expr in EXPRESSIONS:
                    base = os.path.join(split_root, pid, "S001", light, expr)
                    for angle in range(1, NUM_ANGLES + 1):
                        self.items.append(
                            (os.path.join(base, f"C{angle}.jpg"),
                             os.path.join(base, f"C{angle}.txt")))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Sample:
        img_path, meta_path = self.items[index]
        img = _crop_by_head(imread_rgb(img_path, reader="pil"),
                            _read_meta(meta_path))
        return {"image": _to_float(_bicubic(img, self.size))}


class KFaceCropHRDataset(Dataset):
    def __init__(self, root: str, split: str = "train", size: int = 128):
        self.size = size
        self.items = []
        split_root = os.path.join(root, split)
        for pid in os.listdir(split_root):
            for light in CROP_LIGHT_CONDITIONS:
                for expr in EXPRESSIONS:
                    base = os.path.join(split_root, pid, "S001", light, expr)
                    for angle in range(1, NUM_ANGLES + 1):
                        p = os.path.join(base, f"C{angle}.jpg")
                        if os.path.exists(p):
                            self.items.append(p)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Sample:
        img = imread_rgb(self.items[index], reader="pil")
        return {"image": _to_float(_bicubic(img, self.size))}
