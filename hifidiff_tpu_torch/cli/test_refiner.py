"""Full-pipeline eval CLI (counterpart of hifidiff_tpu/cli/test_refiner.py,
the reference's `test_refiner.py`).

DDIM-50 with the reference's eval scheduler config (clip_sample, range 3.0,
`test_refiner.py:166-171`), batch-global min-max normalization of
prediction and ground truth before the metrics (`:113-119`), PSNR / SSIM
(`eval.metrics.reference_eval_metrics`), image grids every `grid_every`
batches (`--grid-every 0` turns them off). With `--vgg16-ckpt` (a
torchvision vgg16 state dict) and `--lpips-ckpt` (lpips' linear heads) the
batch-mean LPIPS of the normalized images (`eval/lpips.py`, the VGG16
trunk), and with `--niqe-model` (an `.npz` with `mu` and `cov` from
`eval.niqe.fit_niqe_model`) the mean NIQE of the normalized predictions on
the host (`eval/niqe.py`). Returns {"psnr", "ssim"} and "lpips" / "niqe"
where asked for. Batch i samples its noise from `seeded_generator(seed,
i)`, the counterpart of the JAX CLI's `fold_in(key, i)`.

It runs on one device, the card unless `--device cpu`, on `--synthetic N`
or `--procedural N` data (the held-out split), or on `--dataroot` (K-Face:
its val split, `data.kface.KFaceDataset`, as the JAX CLI reads it).

    python -m hifidiff_tpu_torch.cli.test_refiner --refiner-ckpt ... \
        --cr-ckpt ... --vae-ckpt ... --procedural 64
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from hifidiff_tpu_torch.cli.common import (data_parallel, load_refiner_stack,
                                           load_tiny_seams, parse_config,
                                           require_data, sampler_noise,
                                           seeded_generator, shard,
                                           smoke_datasets)
from hifidiff_tpu_torch.data.core import Loader
from hifidiff_tpu_torch.parallel.distributed import (global_means,
                                                     is_main_process)
from hifidiff_tpu_torch.eval.metrics import reference_eval_metrics
from hifidiff_tpu_torch.pipeline import (RefinerPipelineConfig,
                                         build_refiner_sampler_split)
from hifidiff_tpu_torch.utils.logging import save_image_grid, side_by_side


@dataclasses.dataclass
class Config:
    dataroot: str = ""         # K-Face (its val split)
    refiner_ckpt: str = ""
    cr_ckpt: str = ""
    vae_ckpt: str = ""
    batch_size: int = 4
    size: int = 128
    num_inference_steps: int = 50
    sampler: str = "ddim"      # or "dpmpp" (DPM-Solver++ 2M)
    clip_sample_range: float = 3.0
    # model-size knobs (defaults = reference architecture)
    width: int = 128
    enc_depths: str = "2,2,4,8"
    mid_depth: int = 8
    dec_depths: str = "2,2,2,2"
    idc_stages: str = "3,4,6,3"
    cr_width: int = 32
    cr_enc_depths: str = "2,2,4,8"
    cr_mid_depth: int = 8
    vae_blocks: str = "128,256,512,512"
    vae_layers: int = 2
    seed: int = 0
    synthetic: int = 0
    procedural: int = 0
    proc_id_spread: float = 1.0   # <1: hard-identity family
    proc_light_jitter: float = 0.0  # >0: per-sample input lighting nuisance
    proc_detail: float = 0.0    # >0: per-identity facial-mark detail
    proc_clutter: int = 0       # >0: per-sample background shapes
    grid_every: int = 10
    out_dir: str = "output/test_refiner"
    niqe_model: str = ""        # .npz with mu/cov from eval.niqe.fit_niqe_model
    vgg16_ckpt: str = ""        # torchvision vgg16 state_dict (for LPIPS)
    lpips_ckpt: str = ""        # lpips linear-head state_dict (for LPIPS)
    tae_ckpt: str = ""          # the tiny autoencoder (cli/common.py)
    tae_mode: str = "both"      # "decode" = tiny decoder only; "both" also
    # replaces the CR-latent encode (deterministic posterior mean)
    tiny_cr_ckpt: str = ""      # the TinyCR at the CR seam
    tiny_cr_width: int = 64     # student arch (must match the ckpt)
    tiny_cr_blocks: int = 4
    tiny_cr_down: int = 2
    device: str = "cuda"        # "cpu" only when asked for


def _check_flags(cfg: Config) -> None:
    require_data(cfg, ("dataroot",))
    if bool(cfg.vgg16_ckpt) != bool(cfg.lpips_ckpt):
        raise ValueError("LPIPS needs both --vgg16-ckpt and --lpips-ckpt")
    for path in (cfg.niqe_model, cfg.vgg16_ckpt, cfg.lpips_ckpt):
        if path and not os.path.exists(path):
            raise FileNotFoundError(f"no file at {path}")


def perceptual_metrics(cfg: Config, device):
    """(lpips_fn, niqe_fn) for the flags given, else None: `lpips_fn(pred_n,
    gt_n)` the batch mean of the VGG16 LPIPS of two NHWC batches in [0, 1]
    on `device`; `niqe_fn(image)` the NIQE of one NHWC image in [0, 1] on
    the host."""
    lpips_fn = niqe_fn = None
    if cfg.vgg16_ckpt and cfg.lpips_ckpt:
        from hifidiff_tpu_torch.cli.common import read_state_dict
        from hifidiff_tpu_torch.eval.lpips import (load_lpips_params,
                                                   lpips_distance)

        net, lins = load_lpips_params(read_state_dict(cfg.vgg16_ckpt),
                                      read_state_dict(cfg.lpips_ckpt))
        net.to(device)
        lins = [w.to(device) for w in lins]

        @torch.no_grad()
        def lpips_fn(a, b):
            return float(lpips_distance(net, lins, a.permute(0, 3, 1, 2),
                                        b.permute(0, 3, 1, 2)).mean())
    if cfg.niqe_model:
        from hifidiff_tpu_torch.eval.niqe import niqe

        m = np.load(cfg.niqe_model)
        mu, cov = m["mu"], m["cov"]

        def niqe_fn(image):
            return niqe(image, mu, cov)
    return lpips_fn, niqe_fn


def main(argv=None) -> dict:
    cfg = parse_config(Config, argv, "Full-pipeline eval")
    _check_flags(cfg)
    device, group = data_parallel(cfg, "test_refiner")
    cr, vae, refiner, latent = load_refiner_stack(cfg, device)
    sampler = build_refiner_sampler_split(
        refiner, cr, vae,
        RefinerPipelineConfig(
            num_inference_steps=cfg.num_inference_steps,
            latent_size=latent, sampler=cfg.sampler, io_uint8=False,
            clip_sample=True, clip_sample_range=cfg.clip_sample_range),
        device=device, **load_tiny_seams(cfg, latent, device))

    smoke = smoke_datasets(cfg, ("lr", "gt", "patches"))
    if smoke is not None:
        ds = smoke[1]  # the held-out split, matching train-CLI val data
    else:
        from hifidiff_tpu_torch.data.kface import KFaceDataset

        ds = KFaceDataset(cfg.dataroot, split="val", size=cfg.size)
    loader = Loader(ds, cfg.batch_size, shuffle=False, **shard())
    lpips_fn, niqe_fn = perceptual_metrics(cfg, device)

    psnrs, ssims, lpipss, niqes = [], [], [], []
    for i, batch in enumerate(loader):
        lr = torch.from_numpy(batch["lr"]).to(device)
        gt = torch.from_numpy(batch["gt"]).to(device)
        pred = sampler(lr, **sampler_noise(
            sampler, len(lr), seeded_generator(cfg.seed, i, device), group))
        m, pred_n, gt_n = reference_eval_metrics(pred, gt, group)
        psnrs.append(float(m["psnr"]))
        ssims.append(float(m["ssim"]))
        if lpips_fn is not None:
            lpipss.append(global_means(
                {"lpips": float(lpips_fn(pred_n, gt_n))}, len(lr),
                group)["lpips"])
        if niqe_fn is not None:
            niqes.extend(niqe_fn(p) for p in pred_n.cpu().numpy())
        if cfg.grid_every and i % cfg.grid_every == 0:
            save_image_grid(
                side_by_side(batch["lr"], pred.float().cpu().numpy(),
                             batch["gt"]),
                os.path.join(cfg.out_dir, f"batch_{i}.png"))
        if is_main_process():
            print(f"({i + 1}/{len(loader)}) psnr={psnrs[-1]:.3f} "
                  f"ssim={ssims[-1]:.4f}", flush=True)

    print(f"PSNR: {np.mean(psnrs):.4f}")
    print(f"SSIM: {np.mean(ssims):.4f}")
    out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
    if lpipss:
        print(f"LPIPS: {np.mean(lpipss):.4f}")
        out["lpips"] = float(np.mean(lpipss))
    if niqes:   # per face, over every process's faces
        out["niqe"] = global_means({"niqe": float(np.mean(niqes))},
                                   len(niqes), group)["niqe"]
        print(f"NIQE: {out['niqe']:.4f}")
    return out


if __name__ == "__main__":
    main()
