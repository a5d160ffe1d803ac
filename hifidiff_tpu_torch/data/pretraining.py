"""HQ face datasets for unconditional denoiser pretraining (counterpart of
hifidiff_tpu/data/pretraining.py, the reference's `dataset_pretraining.py`):
Multi-PIE frontal+moderate crops (cv2-bicubic resize) and flat-directory
CelebA-HQ (PIL-bicubic resize), both returning float32 [0,1] NHWC RGB under
key "image".

`CelebAHQDataset` lists the JAX module's `IMG_EXTS` (`.png`, `.jpg`,
`.jpeg`, `.bmp`, `.webp`) and reads each file as PIL reads it (no EXIF
orientation). `MultiPIEHQDataset` reads as cv2 reads
(`multipie.imread_f32`: the EXIF orientation applied).
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

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int) -> Sample:
        img = imread_rgb(self.paths[index], reader="pil")
        return {"image": pil_bicubic_f32(img, self.size)}
