"""Quality cost of the fast samplers on the trained convergence stack
(counterpart of the JAX package's `scripts/cache_quality.py`): the cached
DDIM sampler (encoder propagation, `cache_interval`), DPM-Solver++ (2M) at
fewer steps, and steps x cache compositions, each against the exact
DDIM-50 sampler (x0 clipped to +-3.0, the eval CLI's configuration).

For each row it reports

  * drift PSNR: the row's faces against the exact sampler's (the
    trajectory's approximation error, what the fast mode costs),
  * gt PSNR / gt SSIM (pyiqa conventions, `eval/metrics.py`): the row's
    faces against the ground truth (does end quality drop?).

Every row samples the same draws: the posterior noise and the initial
latents come from one generator seeded with `--seed`, drawn once and given
to every call, so that drift measures the trajectory and not the noise. The
faces are the held-out procedural split's first `--batch-size` items (the
data `test_refiner --procedural` evaluates).

Uses the stage files `python -m hifidiff_tpu_torch.cli.convergence_demo`
writes (`runs/convergence/ckpt/{cr,vae,refiner}/convdemo`), the width-32
stack at 32 px; `--ckpt-root ""` draws a random stack from `--seed`.
Writes CACHE_QUALITY_TORCH.json at the repo root.

    python -m hifidiff_tpu_torch.scripts.cache_quality
    python -m hifidiff_tpu_torch.scripts.cache_quality --device cpu
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from hifidiff_tpu_torch.cli.common import parse_config
from hifidiff_tpu_torch.scripts.common import (Run, drift_psnr, gt_metrics,
                                               record_path, val_batch)


@dataclasses.dataclass
class Config:
    # convergence-demo architecture (cli/convergence_demo.py) + checkpoints
    ckpt_root: str = "runs/convergence/ckpt"
    name: str = "convdemo"
    size: int = 32
    width: int = 32
    procedural: int = 64   # must stay > 0 (smoke_datasets source)
    proc_id_spread: float = 1.0   # match the stack's training family
    proc_light_jitter: float = 0.0  # (hard tier: 0.6 / 0.25)
    proc_detail: float = 0.0    # >0: per-identity facial-mark detail
    proc_clutter: int = 0       # >0: per-sample background shapes
    synthetic: int = 0     # read by smoke_datasets' fallback branch
    batch_size: int = 16
    seed: int = 0
    steps: int = 50
    intervals: str = "2,3,5"
    dpmpp_steps: str = "10,15,20"
    combos: str = "20:2,15:2,10:2,15:3"  # "steps:cache" compositions
    vae_blocks: str = "32,32"  # demo VAE widths; len L => factor 2^(L-1)
    # ("32,32,32,32" for the 128px reference-geometry tier)
    out: str = record_path("CACHE_QUALITY_TORCH.json")
    device: str = "cuda"    # "cpu" only when asked for


def build_stack(cfg: Config, device) -> Tuple:
    """The demo's narrow stack (CR width `cfg.width`, enc (1, 1), mid 1,
    dec (2, 2); refiner enc (1, 1), mid 1, dec (1, 1), IDC stages
    (1, 1, 1, 1); the VAE `--vae-blocks`, one layer a block) in float32,
    eval mode, on `device`, with the demo's stage files under
    `cfg.ckpt_root`, or drawn from `cfg.seed` where it is empty. Returns
    (cr, vae, refiner, latent)."""
    from hifidiff_tpu_torch.cli import test_refiner
    from hifidiff_tpu_torch.cli.common import load_refiner_stack

    def ck(stage):
        return os.path.join(cfg.ckpt_root, stage, cfg.name) \
            if cfg.ckpt_root else ""

    stack_cfg = test_refiner.Config(
        refiner_ckpt=ck("refiner"), cr_ckpt=ck("cr"), vae_ckpt=ck("vae"),
        size=cfg.size, width=cfg.width, enc_depths="1,1", mid_depth=1,
        dec_depths="1,1", idc_stages="1,1,1,1", cr_width=cfg.width,
        cr_enc_depths="1,1", cr_mid_depth=1, vae_blocks=cfg.vae_blocks,
        vae_layers=1, seed=cfg.seed, device=str(device))
    return load_refiner_stack(stack_cfg, device)


def draws(cfg: Config, batch: int, latent: int,
          device) -> Dict[str, torch.Tensor]:
    """The noise every row samples: the posterior's, then the initial
    latents, NHWC (batch, latent, latent, 4), from one generator on
    `device` seeded with `cfg.seed` (the order the sampler draws them)."""
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    shape = (batch, latent, latent, 4)
    return {"posterior_noise": torch.randn(shape, generator=g,
                                           device=device),
            "latents_noise": torch.randn(shape, generator=g, device=device)}


def sample(stack: Tuple, cfg: Config, lr: np.ndarray,
           noise: Dict[str, torch.Tensor], device,
           **options) -> Tuple[np.ndarray, np.ndarray]:
    """One row: the split sampler at `cfg.steps` DDIM steps with the eval
    CLI's clipping and `options` (RefinerPipelineConfig fields), on float
    faces in [0, 1]. Returns (final latents, faces), NHWC float32."""
    from hifidiff_tpu_torch.pipeline import (RefinerPipelineConfig,
                                             build_refiner_sampler_split)

    cr, vae, refiner, latent = stack
    kw = dict(num_inference_steps=cfg.steps, latent_size=latent,
              clip_sample=True, clip_sample_range=3.0, io_uint8=False)
    kw.update(options)
    sampler = build_refiner_sampler_split(
        refiner, cr, vae, RefinerPipelineConfig(**kw), device=device)
    st = sampler.stages
    with torch.inference_mode():
        final = st["scan"](*st["prep"](
            torch.from_numpy(lr).to(device),
            noise["posterior_noise"].to(device),
            noise["latents_noise"].to(device)))
        faces = st["decode"](final)
    return (final.permute(0, 2, 3, 1).float().cpu().numpy(),
            faces.float().cpu().numpy())


def rows(cfg: Config) -> List[Tuple[str, str, Dict]]:
    """(section, key, sampler options) of every row after the exact one, in
    the JAX script's order."""
    out = [("intervals", str(k), dict(cache_interval=k))
           for k in (int(s) for s in cfg.intervals.split(","))]
    out += [("dpmpp", str(n), dict(sampler="dpmpp", num_inference_steps=n))
            for n in (int(s) for s in cfg.dpmpp_steps.split(","))]
    for combo in (s for s in cfg.combos.split(",") if s):
        n, k = (int(v) for v in combo.split(":"))
        out.append(("combos", combo, dict(num_inference_steps=n,
                                          cache_interval=k)))
    return out


def evaluate(cfg: Config, device) -> Tuple[Dict, Dict]:
    """The rows on `device`. Returns (the JAX script's result dict, the
    runs: {"batch", "noise", "stack", "exact" and "<section>/<key>":
    (final latents, faces)})."""
    stack = build_stack(cfg, device)
    batch = val_batch(cfg, cfg.batch_size)
    noise = draws(cfg, cfg.batch_size, stack[3], device)
    runs: Dict = {"batch": batch, "noise": noise, "stack": stack}

    exact = runs["exact"] = sample(stack, cfg, batch["lr"], noise, device)
    ep, es = gt_metrics(exact[1], batch["gt"])
    result = {"trained": bool(cfg.ckpt_root), "size": cfg.size,
              "steps": cfg.steps, "exact_gt_psnr": round(ep, 2),
              "exact_gt_ssim": round(es, 4), "intervals": {}, "dpmpp": {},
              "combos": {}}
    for section, key, options in rows(cfg):
        out = runs[f"{section}/{key}"] = sample(stack, cfg, batch["lr"],
                                                noise, device, **options)
        gp, gs = gt_metrics(out[1], batch["gt"])
        row = {"drift_psnr": round(drift_psnr(out[1], exact[1]), 2),
               "gt_psnr": round(gp, 2), "gt_ssim": round(gs, 4)}
        result[section][key] = row
        print(f"{section} {key}: drift {row['drift_psnr']:.2f} dB, "
              f"gt {row['gt_psnr']:.2f} dB / {row['gt_ssim']:.4f} "
              f"(exact gt {result['exact_gt_psnr']:.2f} / "
              f"{result['exact_gt_ssim']:.4f})", flush=True)
    return result, runs


def main(argv=None) -> dict:
    cfg = parse_config(Config, argv, "Cached-sampling quality (trained)")
    run = Run(cfg.device, "cache_quality", argv)
    result, _ = evaluate(cfg, run.device)
    return run.finish(result, cfg.out)


if __name__ == "__main__":
    main()
