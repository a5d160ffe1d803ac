"""CR single-image inference CLI (counterpart of
hifidiff_tpu/cli/infer_cr.py, the reference's `infer_cr.py`).

Single-image path (`infer_cr.py:52-56`): read one PNG (`data/image_io`),
PIL-bicubic down to 32x32 and up to `--size` (`data/resize.resize_pil`),
run the CR, save the restored face as a PNG grid of one.

`--ckpt` takes a reference torch file (`.pt` / `.pth`, the reference's
names, or a `.safetensors` file) or a `train_cr` checkpoint directory of
the port (its latest `step_<n>.pt`); the CR is built from the size flags
and loaded strictly. Without `--ckpt` it warns and keeps the CR's seeded
random init, as the port's CLIs draw one. It runs on the card unless
`--device cpu`.

Batch mode (`--dataroot`, the K-Face val split) is refused until the codec
slice brings JPEG (ROADMAP §A9.2, step 3).

    python -m hifidiff_tpu_torch.cli.infer_cr --ckpt cr.pt --image face.png \
        --output out.png
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hifidiff_tpu_torch.cli.common import (CODEC_SLICE, KFACE, build_cr,
                                           load_weights, parse_config,
                                           seeded, to_nhwc)
from hifidiff_tpu_torch.data.image_io import imread_rgb
from hifidiff_tpu_torch.data.resize import resize_pil
from hifidiff_tpu_torch.devices import resolve_device
from hifidiff_tpu_torch.utils.logging import save_image_grid


@dataclasses.dataclass
class Config:
    ckpt: str = ""
    image: str = ""             # single-image mode
    dataroot: str = ""          # batch mode over K-Face: JPEG, refused
    split: str = "val"
    batch_size: int = 8
    output: str = "cr_output.png"
    out_dir: str = "output/infer_cr"
    size: int = 128
    width: int = 32
    enc_depths: str = "2,2,4,8"
    mid_depth: int = 8
    seed: int = 0
    device: str = "cuda"        # "cpu" only when asked for


def load_cr(cfg: Config, device) -> torch.nn.Module:
    """The CR of cfg's size flags with the weights of `cfg.ckpt` (the seeded
    random init with a warning without one), on `device`, in eval mode."""
    with seeded(cfg.seed):
        cr = build_cr(cfg.width, cfg.size, cfg.enc_depths, cfg.mid_depth)
    if cfg.ckpt:
        load_weights(cr, cfg.ckpt, "CR")
    else:
        print("[warn] no --ckpt: random CR weights")
    return cr.to(device).eval()


def lr_input(path: str, size: int) -> np.ndarray:
    """The LR protocol of the single-image path: the PNG at `path`,
    PIL-bicubic to 32x32, then to size x size, as (1, size, size, 3)
    float32 in [0, 1]."""
    img = resize_pil(resize_pil(imread_rgb(path), (32, 32), "bicubic"),
                     (size, size), "bicubic")
    return (img.astype(np.float32) / 255.0)[None]


def main(argv=None) -> np.ndarray:
    """Returns the restored face, (1, size, size, 3) float32 in [0, 1]."""
    cfg = parse_config(Config, argv, "CR inference")
    if cfg.dataroot and not cfg.image:
        raise NotImplementedError(
            f"--dataroot: {KFACE}, and {CODEC_SLICE}; give --image")
    if not cfg.image:
        raise ValueError("--image is required (--dataroot waits for the "
                         "codec slice)")
    device = resolve_device(cfg.device, "infer_cr")
    x = lr_input(cfg.image, cfg.size)
    cr = load_cr(cfg, device)
    with torch.inference_mode():
        pred = cr(torch.from_numpy(x).permute(0, 3, 1, 2).to(device))
        out = to_nhwc(pred.clamp(0.0, 1.0))
    save_image_grid(out, cfg.output, nrow=1)
    print(f"saved {cfg.output}")
    return out


if __name__ == "__main__":
    main()
