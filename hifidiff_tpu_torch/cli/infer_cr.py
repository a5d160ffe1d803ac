"""CR single-image inference CLI (counterpart of
hifidiff_tpu/cli/infer_cr.py, the reference's `infer_cr.py`).

Single-image path (`infer_cr.py:52-56`): read one PNG, JPEG, WebP or BMP
(`data/image_io`, as PIL reads it), PIL-bicubic down to 32x32 and up to
`--size` (`data/resize.resize_pil`), run the CR, save the restored face as
a PNG grid of one.

`--ckpt` takes a reference torch file (`.pt` / `.pth`, the reference's
names, or a `.safetensors` file) or a `train_cr` checkpoint directory of
the port (its latest `step_<n>.pt`); the CR is built from the size flags
and loaded strictly. Without `--ckpt` it warns and keeps the CR's seeded
random init, as the port's CLIs draw one. It runs on the card unless
`--device cpu`.

Batch mode (`--dataroot` without `--image`, the reference's `infer_loop`,
`infer_cr.py:15-33`): the K-Face split `--split` (`data.kface.KFaceDataset`)
in batches of `--batch-size`, the cr_loss of each printed and a
`[lr | pred | gt]` grid written per batch under `--out-dir`.

    python -m hifidiff_tpu_torch.cli.infer_cr --ckpt cr.pt --image face.jpg \
        --output out.png
    python -m hifidiff_tpu_torch.cli.infer_cr --ckpt cr.pt --dataroot /data/kface
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hifidiff_tpu_torch.cli.common import (build_cr, load_weights,
                                           parse_config, seeded, to_nhwc)
from hifidiff_tpu_torch.parallel.mesh import to_device
from hifidiff_tpu_torch.data.image_io import imread_rgb
from hifidiff_tpu_torch.data.resize import resize_pil
from hifidiff_tpu_torch.devices import resolve_device
from hifidiff_tpu_torch.utils.logging import save_image_grid


@dataclasses.dataclass
class Config:
    ckpt: str = ""
    image: str = ""             # single-image mode
    dataroot: str = ""          # batch mode over K-Face
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
    """The LR protocol of the single-image path: the image at `path`,
    PIL-bicubic to 32x32, then to size x size, as (1, size, size, 3)
    float32 in [0, 1]."""
    img = imread_rgb(path, reader="pil")
    img = resize_pil(resize_pil(img, (32, 32), "bicubic"), (size, size),
                     "bicubic")
    return (img.astype(np.float32) / 255.0)[None]


def infer_batch(cfg: Config, cr: torch.nn.Module, device) -> np.ndarray:
    """Dataset sweep with cr_loss + [lr|pred|gt] dumps (the reference's
    `infer_loop`); returns the restored faces, (N, size, size, 3)."""
    import os

    from hifidiff_tpu_torch.data.core import Loader
    from hifidiff_tpu_torch.data.kface import KFaceDataset
    from hifidiff_tpu_torch.train.losses import cr_loss
    from hifidiff_tpu_torch.utils.logging import side_by_side

    ds = KFaceDataset(cfg.dataroot, split=cfg.split, size=cfg.size)
    loader = Loader(ds, cfg.batch_size, shuffle=False)
    losses, preds = [], []
    for i, batch in enumerate(loader):
        on_device = to_device(batch, device)
        with torch.inference_mode():
            pred = cr(on_device["lr"])
            losses.append(float(cr_loss(pred, on_device["gt"],
                                        on_device["patches"])))
            out = to_nhwc(pred.clamp(0.0, 1.0))
        preds.append(out)
        save_image_grid(side_by_side(batch["lr"], out, batch["gt"]),
                        os.path.join(cfg.out_dir, f"batch_{i}.png"))
        print(f"({i + 1}/{len(loader)}) cr_loss={losses[-1]:.5f}",
              flush=True)
    print(f"mean cr_loss: {np.mean(losses):.5f}")
    return np.concatenate(preds)


def main(argv=None) -> np.ndarray:
    """Returns the restored faces, (N, size, size, 3) float32 in [0, 1]
    (N = 1 on the single-image path)."""
    cfg = parse_config(Config, argv, "CR inference")
    if not (cfg.image or cfg.dataroot):
        raise ValueError("--image or --dataroot is required")
    device = resolve_device(cfg.device, "infer_cr")
    if cfg.dataroot and not cfg.image:
        return infer_batch(cfg, load_cr(cfg, device), device)
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
