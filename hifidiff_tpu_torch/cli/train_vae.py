"""Stage-0 VAE training CLI (counterpart of hifidiff_tpu/cli/train_vae.py).

The reference freezes an externally pretrained SD-2.1 VAE and never fits
one; this stage fits the `AutoencoderKL` so that the whole pipeline trains
self-contained (the convergence demo starts here). Reconstruction MSE +
beta * KL, AdamW + cosine; after every epoch the posterior-mean
reconstruction PSNR on the val set, and a `[input | recon]` grid every
`save_image_epoch` epochs. Its checkpoint directory is what every later
stage's `--vae-ckpt` reads.

It runs on one device, the card unless `--device cpu`, on `--synthetic N` or
`--procedural N` data, or on the images of `--multipie-root` (a Multi-PIE
tree's train split) and `--celeba-root` (a flat directory of PNG, JPEG,
WebP and BMP files).

    python -m hifidiff_tpu_torch.cli.train_vae --procedural 64 --size 32 \
        --vae-blocks 32,32 --vae-layers 1    # tiny demo fit
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch

from hifidiff_tpu_torch.cli.common import (EvalModule, data_parallel, graphed,
                                           hq_datasets, parse_config,
                                           parse_ints, require_data, resume,
                                           seeded, seeded_generator, shard,
                                           smoke_datasets, to_nhwc)
from hifidiff_tpu_torch.parallel.distributed import global_means
from hifidiff_tpu_torch.data.core import Loader
from hifidiff_tpu_torch.parallel.mesh import device_prefetch, to_device
from hifidiff_tpu_torch.train.checkpoint import CheckpointManager
from hifidiff_tpu_torch.train.optim import adamw_cosine
from hifidiff_tpu_torch.train.steps import TrainState, make_vae_train_step
from hifidiff_tpu_torch.utils.logging import (MetricsLogger, StepTimer,
                                              save_image_grid, side_by_side)
from hifidiff_tpu_torch.vae.model import AutoencoderKL, flax_default_init_


@dataclasses.dataclass
class Config:
    name: str = "temp"
    log_dir: str = "logs"
    multipie_root: str = ""    # PNG
    celeba_root: str = ""      # PNG
    num_epochs: int = 100
    batch_size: int = 64
    lr: float = 1e-4
    warmup_steps: int = 500
    accum_steps: int = 1
    beta_kl: float = 1e-6   # SD-style tiny KL weight
    size: int = 128
    vae_blocks: str = "128,256,512,512"
    vae_layers: int = 2
    ema_decay: float = 0.0
    seed: int = 0
    synthetic: int = 0
    procedural: int = 0
    proc_id_spread: float = 1.0   # <1: hard-identity family
    proc_light_jitter: float = 0.0  # >0: per-sample input lighting nuisance
    proc_detail: float = 0.0    # >0: per-identity facial-mark detail
    proc_clutter: int = 0       # >0: per-sample background shapes
    save_model_epoch: int = 10
    save_image_epoch: int = 1
    out_dir: str = "output/vae"
    ckpt_dir: str = "checkpoints/vae"
    use_wandb: bool = False
    resume: bool = False
    device: str = "cuda"        # "cpu" only when asked for
    cuda_graphs: bool = False   # capture the train step (the card only)


@torch.no_grad()
def recon_psnr(vae: AutoencoderKL, images: torch.Tensor, group=None):
    """The posterior-mean reconstruction of [0, 1] images (B, 3, H, W) and
    its PSNR in the [0, 1] domain; with a data-parallel `group` the PSNR of
    the global batch's mean squared error."""
    target = images.clamp(0.0, 1.0)
    rec = vae.decode(vae.encode(target * 2.0 - 1.0))
    rec01 = (rec * 0.5 + 0.5).clamp(0.0, 1.0)
    mse = global_means({"mse": float((rec01 - target).square().mean())},
                             len(images), group)["mse"]
    return rec01, -10.0 * math.log10(max(mse, 1e-12))


def main(argv=None) -> None:
    cfg = parse_config(Config, argv, "Stage-0 VAE training")
    require_data(cfg, ("multipie_root", "celeba_root"))
    device, group = data_parallel(cfg, "train_vae")
    # the real data's train and val sets are one, as the JAX CLI has them
    train_ds, val_ds = smoke_datasets(cfg, ("image",)) or (
        hq_datasets(cfg),) * 2
    train_loader = Loader(train_ds, cfg.batch_size, shuffle=True,
                          seed=cfg.seed, **shard())
    val_loader = Loader(val_ds, cfg.batch_size, shuffle=False, **shard())

    with seeded(cfg.seed):   # drawn as the JAX CLI's `vae.init` draws it
        vae = flax_default_init_(AutoencoderKL(
            block_out=parse_ints(cfg.vae_blocks),
            layers_per_block=cfg.vae_layers))
    total_steps = len(train_loader) * cfg.num_epochs
    state = TrainState.create(
        vae, functools.partial(adamw_cosine, base_lr=cfg.lr,
                               warmup_steps=cfg.warmup_steps,
                               total_steps=total_steps,
                               accumulate_steps=cfg.accum_steps,
                               capturable=cfg.cuda_graphs),
        ema_decay=cfg.ema_decay, device=device, group=group)
    ckpt = CheckpointManager(os.path.join(cfg.ckpt_dir, cfg.name))
    start_epoch = resume(cfg, ckpt, state, train_loader)
    train_step = graphed(cfg, make_vae_train_step(beta_kl=cfg.beta_kl,
                                                  device=device))
    evaluated = EvalModule(state)

    logger = MetricsLogger(cfg.log_dir, "hifi_vae", cfg.name,
                           use_wandb=cfg.use_wandb)
    timer = StepTimer()
    step = state.step
    for epoch in range(start_epoch, cfg.num_epochs):
        for batch in device_prefetch(train_loader, device):
            state, metrics = train_step(
                state, batch,
                generator=seeded_generator(cfg.seed, step, device))
            timer.tick()
            logger.log({"train_loss": metrics["loss"],
                        "rec_loss": metrics["rec"], "kl": metrics["kl"],
                        "step_time": timer.mean, "epoch": epoch}, step)
            step += 1

        # val: posterior-mean recon PSNR
        psnrs = []
        model = evaluated()
        for i, batch in enumerate(val_loader):
            rec, p = recon_psnr(model, to_device(batch, device)["image"],
                                group)
            psnrs.append(p)
            if i == 0 and epoch % cfg.save_image_epoch == 0:
                save_image_grid(
                    side_by_side(batch["image"], to_nhwc(rec)),
                    os.path.join(cfg.out_dir, cfg.name, f"val_e{epoch}.png"))
        logger.log({"val_psnr": float(np.mean(psnrs))}, step)

        if epoch % cfg.save_model_epoch == 0 or epoch == cfg.num_epochs - 1:
            ckpt.save(step, state)
    logger.close()


if __name__ == "__main__":
    main()
