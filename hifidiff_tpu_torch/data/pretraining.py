"""HQ face datasets for unconditional denoiser pretraining (counterpart of
hifidiff_tpu/data/pretraining.py, the reference's `dataset_pretraining.py`):
Multi-PIE frontal+moderate crops (cv2-bicubic resize) and flat-directory
CelebA-HQ (PIL-bicubic resize), both returning float32 [0,1] NHWC RGB under
key "image".

`CelebAHQDataset` lists the JAX module's `IMG_EXTS`. The port reads PNG,
JPEG and BMP (`.png`, `.jpg`, `.jpeg`, `.bmp`) as PIL reads them: a
directory that also holds a `.webp` file is refused at construction,
naming them (ROADMAP §A); no file is skipped. `MultiPIEHQDataset` reads
as cv2 reads (`multipie.imread_f32`).
"""

from __future__ import annotations

import os

from hifidiff_tpu_torch.data.core import Dataset, Sample
from hifidiff_tpu_torch.data.image_io import imread_rgb
from hifidiff_tpu_torch.data.multipie import (ANGLES_MODERATE,
                                              GT_ANGLES_FRONTAL, LIGHT_COND,
                                              imread_f32, pil_bicubic_f32)
from hifidiff_tpu_torch.data.resize import resize_cv2

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
READ_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


class MultiPIEHQDataset(Dataset):
    def __init__(self, root: str, split: str = "train", size: int = 128):
        self.size = size
        split_root = os.path.join(root, split)
        angles = [*ANGLES_MODERATE, GT_ANGLES_FRONTAL[0]]
        self.paths = []
        for pid in sorted(os.listdir(split_root)):
            for angle in angles:
                for light in LIGHT_COND:
                    p = os.path.join(split_root, pid, angle, f"{light}.png")
                    if os.path.exists(p):
                        self.paths.append(p)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int) -> Sample:
        img = imread_f32(self.paths[index])
        return {"image": resize_cv2(img, (self.size, self.size), "cubic")}


class CelebAHQDataset(Dataset):
    def __init__(self, root: str, size: int = 128):
        self.size = size
        self.paths = [
            os.path.join(root, f) for f in sorted(os.listdir(root))
            if os.path.isfile(os.path.join(root, f))
            and f.lower().endswith(IMG_EXTS)
        ]
        other = [p for p in self.paths if not p.lower().endswith(READ_EXTS)]
        if other:
            raise NotImplementedError(
                f"CelebAHQDataset({root!r}): {len(other)} WebP files the "
                f"port does not decode, e.g. {other[:3]}; it reads PNG, "
                "JPEG and BMP (ROADMAP §A)")

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int) -> Sample:
        img = imread_rgb(self.paths[index], sixteen_bit="pil")
        return {"image": pil_bicubic_f32(img, self.size)}
