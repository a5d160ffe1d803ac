"""Multi-PIE datasets (counterpart of hifidiff_tpu/data/multipie.py; NHWC
numpy, the same `split=` API, constants, item lists, draws and outputs).

Layout `<root>/<split>/<pid>/<angle>/<light>.png`; angle sets EXTREME (8
cams) / MODERATE (6); model_type in {e2m, m2f, e2f, uni} selects the input
and GT angle sets, the GT angle by which half of the angle list the input
comes from; 8-bit quantization of the LR input; optional
`<light>_patch.png` GT component images.

The images are read by the port's decoders (`image_io.imread_rgb`, PNG,
JPEG, WebP or BMP by the file's signature) straight into RGB, each as the
JAX package reads it: `reader="cv2"` where it calls `cv2.imread`
(`imread_f32`, the IDC set: the EXIF orientation applied, 16-bit samples'
high byte), `"pil"` where it calls PIL. They stay RGB:
the JAX package reads BGR with cv2 and flips at the end, and every op
between is channelwise but the blind branch's noise and to-gray, which
`degradations` lays out as on the BGR image. Its cv2 resizes are
`resize.resize_cv2`, its PIL resizes `resize.resize_pil`.

The blind branch (`use_blind=True`, the JAX default) draws as the JAX
package's: the flips, `blind_degrade`, jitter at 0.5, grey at 0.008, then
the cv2-cubic resizes. `native=True` takes `blind_degrade`'s native path,
which the JAX package takes whenever its native library is built.

Reference quirk kept configurable: the reference flips input and GT
*independently* (`dataset_multipie.py:94-99`); `joint_flip=False`
reproduces that, `joint_flip=True` flips them together.
"""

from __future__ import annotations

import os

import numpy as np

from hifidiff_tpu_torch.data.core import Dataset, Sample
from hifidiff_tpu_torch.data.degradations import (blind_degrade,
                                                  color_jitter_pair,
                                                  quantize_8bit, to_gray3)
from hifidiff_tpu_torch.data.image_io import imread_rgb
from hifidiff_tpu_torch.data.resize import resize_cv2, resize_pil

LIGHT_COND = ["%02d" % i for i in range(20)]
ANGLES_EXTREME = ["11_0", "12_0", "09_0", "19_1", "08_1", "20_0", "01_0",
                  "24_0"]
ANGLES_MODERATE = ["08_0", "13_0", "14_0", "05_0", "04_1", "19_0"]
GT_ANGLES_MODERATE = ["08_0", "19_0"]
GT_ANGLES_FRONTAL = ["05_1", "05_1"]


def _angle_sets(model_type: str):
    if model_type == "e2m":
        return ANGLES_EXTREME, GT_ANGLES_MODERATE
    if model_type == "m2f":
        return ANGLES_MODERATE, GT_ANGLES_FRONTAL
    if model_type == "e2f":
        return ANGLES_EXTREME, GT_ANGLES_FRONTAL
    if model_type == "uni":
        return [*ANGLES_EXTREME, *ANGLES_MODERATE], GT_ANGLES_FRONTAL
    raise ValueError(f"unknown model_type: {model_type}")


def imread_f32(path: str) -> np.ndarray:
    """An image file as float32 RGB in [0, 1], read as `cv2.imread` reads
    it (the JAX package's `_imread_f32`): turned by its EXIF orientation,
    16-bit samples keeping their high byte."""
    return imread_rgb(path, reader="cv2").astype(np.float32) / 255.0


def pil_bicubic_f32(img: np.ndarray, *sizes: int) -> np.ndarray:
    """uint8 RGB through PIL-bicubic resizes to each square size in turn,
    as float32 in [0, 1]."""
    for s in sizes:
        img = resize_pil(img, (s, s), "bicubic")
    return img.astype(np.float32) / 255.0


class MultiPIEDataset(Dataset):
    def __init__(self, root: str, split: str = "train",
                 model_type: str = "uni", size: int = 128,
                 use_blind: bool = True, use_patch: bool = False,
                 augment_flip: bool = True, joint_flip: bool = False,
                 seed: int = 0, native: bool = False):
        self.size = size
        self.use_blind = use_blind
        self.native = native
        self.use_patch = use_patch
        self.augment_flip = augment_flip
        self.joint_flip = joint_flip
        self._rng = np.random.default_rng(seed)

        split_root = os.path.join(root, split)
        angles, gt_angles = _angle_sets(model_type)
        self.items = []
        for pid in sorted(os.listdir(split_root)):
            for idx, angle in enumerate(angles):
                gt_angle = (gt_angles[0] if idx < len(angles) // 2
                            else gt_angles[1])
                for light in LIGHT_COND:
                    gt = os.path.join(split_root, pid, gt_angle,
                                      f"{light}.png")
                    inp = os.path.join(split_root, pid, angle, f"{light}.png")
                    if os.path.exists(gt) and os.path.exists(inp):
                        patch = os.path.join(split_root, pid, gt_angle,
                                             f"{light}_patch.png")
                        self.items.append((inp, gt, patch))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Sample:
        inp_path, gt_path, patch_path = self.items[index]
        rng = self._rng
        inp = imread_f32(inp_path)
        gt = imread_f32(gt_path)

        if self.augment_flip:
            if self.joint_flip:
                if rng.uniform() < 0.5:
                    inp, gt = inp[:, ::-1], gt[:, ::-1]
            else:  # reference behavior: independent flips
                if rng.uniform() < 0.5:
                    inp = inp[:, ::-1]
                if rng.uniform() < 0.5:
                    gt = gt[:, ::-1]
        inp = np.ascontiguousarray(inp)
        gt = np.ascontiguousarray(gt)

        if self.use_blind:
            inp = blind_degrade(rng, inp, self.size, native=self.native)
            if rng.uniform() < 0.5:
                inp, gt = color_jitter_pair(rng, inp, gt)
            if rng.uniform() < 0.008:
                inp = to_gray3(inp)
        else:
            inp = resize_cv2(inp, (32, 32), "cubic")

        size = (self.size, self.size)
        inp = resize_cv2(inp, size, "cubic")
        out: Sample = {
            "lr": quantize_8bit(inp),
            "gt": resize_cv2(gt, size, "cubic"),
        }
        if self.use_patch:
            # single patch image -> (1, H, W, C) patch axis for the
            # key-region union mask
            out["patches"] = pil_bicubic_f32(
                imread_rgb(patch_path, reader="pil"), self.size)[None]
        return out


class MultiPIESingleViewDataset(Dataset):
    """Per-angle eval variant: (lr, gt, patch, angle)
    (`dataset_multipie.py:183-247`)."""

    def __init__(self, root: str, angle: str, split: str = "train",
                 size: int = 128):
        self.size = size
        self.angle = angle
        split_root = os.path.join(root, split)
        self.items = []
        for pid in sorted(os.listdir(split_root)):
            for light in LIGHT_COND:
                gt = os.path.join(split_root, pid, GT_ANGLES_FRONTAL[0],
                                  f"{light}.png")
                patch = os.path.join(split_root, pid, GT_ANGLES_FRONTAL[0],
                                     f"{light}_patch.png")
                inp = os.path.join(split_root, pid, angle, f"{light}.png")
                if all(map(os.path.exists, [gt, patch, inp])):
                    self.items.append((inp, gt, patch))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Sample:
        inp, gt, patch = self.items[index]
        size = self.size
        return {
            "lr": pil_bicubic_f32(imread_rgb(inp, reader="pil"), 32,
                                  size),
            "gt": pil_bicubic_f32(imread_rgb(gt, reader="pil"), size),
            "patches": pil_bicubic_f32(imread_rgb(patch, reader="pil"),
                                       size)[None],
            "angle": self.angle,
        }


class MultiPIEInferenceDataset(Dataset):
    """LR inputs + their path strings (`dataset_multipie.py:250-290`)."""

    def __init__(self, root: str, split: str = "train",
                 model_type: str = "uni", size: int = 128):
        self.size = size
        split_root = os.path.join(root, split)
        angles, _ = _angle_sets(model_type)
        self.items = []
        for pid in sorted(os.listdir(split_root)):
            for angle in angles:
                for light in LIGHT_COND:
                    p = os.path.join(split_root, pid, angle, f"{light}.png")
                    if os.path.exists(p):
                        self.items.append(p)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Sample:
        return {"lr": pil_bicubic_f32(imread_rgb(self.items[index],
                                                 reader="pil"), 32,
                                      self.size),
                "path": self.items[index]}


class MultiPIEIDCDataset(Dataset):
    """Triplets for IDC pretraining; negative = random other pid's frontal
    (`dataset_multipie.py:293-371`), drawn at construction from the seeded
    stream as the JAX package draws it. Input degrades by a /4 bicubic
    down/up instead of /8 and is 8-bit quantized."""

    def __init__(self, root: str, split: str = "train", size: int = 128,
                 seed: int = 0):
        self.size = size
        split_root = os.path.join(root, split)
        rng = np.random.default_rng(seed)
        angles = [*ANGLES_EXTREME, *ANGLES_MODERATE]
        pids = sorted(os.listdir(split_root))
        self.items = []
        for pid in pids:
            others = [p for p in pids if p != pid]
            for angle in angles:
                gt_angle = GT_ANGLES_FRONTAL[0]
                for light in LIGHT_COND:
                    gt = os.path.join(split_root, pid, gt_angle,
                                      f"{light}.png")
                    inp = os.path.join(split_root, pid, angle, f"{light}.png")
                    if os.path.exists(gt) and os.path.exists(inp):
                        while True:
                            other_pid = others[int(rng.integers(len(others)))]
                            other = os.path.join(split_root, other_pid,
                                                 gt_angle, f"{light}.png")
                            if os.path.exists(other):
                                break
                        self.items.append((inp, gt, other))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Sample:
        inp_path, gt_path, other_path = self.items[index]
        size = self.size

        def base(p):
            img = resize_cv2(imread_rgb(p, reader="cv2"), (size, size),
                             "cubic")
            return img.astype(np.float32) / 255.0

        inp = resize_cv2(base(inp_path), (size // 4, size // 4), "cubic")
        inp = resize_cv2(inp, (size, size), "cubic")
        return {
            "lr": quantize_8bit(inp),
            "gt": base(gt_path),
            "other": base(other_path),
        }
