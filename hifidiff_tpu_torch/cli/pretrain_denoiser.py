"""Stage-3 unconditional latent-DDPM pretraining CLI (counterpart of
hifidiff_tpu/cli/pretrain_denoiser.py, the reference's
`pretrain_denoiser.py`).

Defaults mirror the reference (`pretrain_denoiser.py:20-46,261-280`): batch
512, AdamW 1e-4 + cosine schedule with 500 warm-up steps, DDPM 1000
scaled_linear epsilon prediction, a frozen VAE (`--vae-ckpt`: a diffusers
state dict or a `train_vae` checkpoint), a DDIM-50 sample grid every
`save_image_epoch` epochs, seed 0. `--accum-steps` accumulates gradients,
`--ema-decay` keeps an EMA of the parameters for the grids, `--remat`
recomputes each block's activations in the backward (less memory, a second
forward of every block), and `--cache-latents` encodes the dataset's VAE
posterior moments once and trains on them (`make_denoiser_train_step_cached`:
the VAE is frozen and the data not augmented, so the moments are constants).
Step n draws its noise from `seeded_generator(seed, n)`.

It runs on one device, the card unless `--device cpu`, on `--synthetic N` or
`--procedural N` data, or on the images of `--multipie-root` (a Multi-PIE
tree's train split) and `--celeba-root` (a flat directory of PNG, JPEG,
WebP and BMP files).

    python -m hifidiff_tpu_torch.cli.pretrain_denoiser --procedural 1024 \
        --vae-ckpt checkpoints/vae/temp
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from hifidiff_tpu_torch.cli.common import (EvalModule, data_parallel, graphed,
                                           hq_datasets, load_vae, parse_config,
                                           parse_ints, require_data, resume,
                                           seeded, seeded_generator, shard,
                                           smoke_datasets)
from hifidiff_tpu_torch.data.core import ArrayDataset, Loader
from hifidiff_tpu_torch.parallel.distributed import is_main_process
from hifidiff_tpu_torch.parallel.mesh import device_prefetch, to_device
from hifidiff_tpu_torch.models.denoiser import Denoiser
from hifidiff_tpu_torch.pipeline import build_unconditional_sampler
from hifidiff_tpu_torch.train.checkpoint import CheckpointManager
from hifidiff_tpu_torch.train.optim import adamw_cosine
from hifidiff_tpu_torch.train.steps import (TrainState,
                                            make_denoiser_train_step,
                                            make_denoiser_train_step_cached)
from hifidiff_tpu_torch.utils.logging import (MetricsLogger, StepTimer,
                                              save_image_grid)
from hifidiff_tpu_torch.vae.model import AutoencoderKL


@dataclasses.dataclass
class Config:
    name: str = "temp"
    log_dir: str = "logs"
    multipie_root: str = ""    # PNG
    celeba_root: str = ""      # PNG
    vae_ckpt: str = ""
    num_epochs: int = 100
    batch_size: int = 512
    lr: float = 1e-4
    warmup_steps: int = 500
    accum_steps: int = 1
    size: int = 128
    sample_size: int = 8
    # model-size knobs (defaults = reference architecture)
    width: int = 128
    enc_depths: str = "2,2,4,8"
    mid_depth: int = 8
    dec_depths: str = "2,2,2,2"
    vae_blocks: str = "128,256,512,512"
    vae_layers: int = 2
    remat: bool = False   # checkpoint the UNet blocks (less device memory)
    cache_latents: bool = False  # the VAE posterior moments once, then the
    # cached-latent step
    ema_decay: float = 0.0  # >0 keeps an EMA of the params for the grids
    seed: int = 0
    synthetic: int = 0
    procedural: int = 0
    proc_id_spread: float = 1.0   # <1: hard-identity family
    proc_light_jitter: float = 0.0  # >0: per-sample input lighting nuisance
    proc_detail: float = 0.0    # >0: per-identity facial-mark detail
    proc_clutter: int = 0       # >0: per-sample background shapes
    save_model_epoch: int = 10
    save_image_epoch: int = 1
    out_dir: str = "output/denoiser"
    ckpt_dir: str = "checkpoints/denoiser"
    use_wandb: bool = False
    resume: bool = False
    device: str = "cuda"        # "cpu" only when asked for
    cuda_graphs: bool = False   # capture the train step (the card only)


@torch.no_grad()
def cache_moments(vae: AutoencoderKL, dataset, batch_size: int,
                  device) -> ArrayDataset:
    """One pass of the frozen encoder over `dataset`: its posterior moments
    as an NHWC dataset {"mean", "logvar"} (unscaled)."""
    means, logvars = [], []
    for b in Loader(dataset, batch_size, shuffle=False, num_threads=2):
        images = to_device(b, device)["image"]
        mean, logvar = vae.moments(images.clamp(0.0, 1.0) * 2.0 - 1.0)
        means.append(mean.permute(0, 2, 3, 1).cpu().numpy())
        logvars.append(logvar.permute(0, 2, 3, 1).cpu().numpy())
    return ArrayDataset({"mean": np.concatenate(means),
                         "logvar": np.concatenate(logvars)})


def main(argv=None) -> None:
    cfg = parse_config(Config, argv, "Stage-3 denoiser pretraining")
    require_data(cfg, ("multipie_root", "celeba_root"))
    device, group = data_parallel(cfg, "pretrain_denoiser")
    train_ds = (smoke_datasets(cfg, ("image",)) or (hq_datasets(cfg),))[0]

    vae_blocks = parse_ints(cfg.vae_blocks)
    latent = cfg.size // (2 ** (len(vae_blocks) - 1))
    with seeded(cfg.seed):
        denoiser = Denoiser(width=cfg.width,
                            enc_nums=parse_ints(cfg.enc_depths),
                            mid_num=cfg.mid_depth,
                            dec_nums=parse_ints(cfg.dec_depths),
                            remat=cfg.remat)
        vae = AutoencoderKL(block_out=vae_blocks,
                            layers_per_block=cfg.vae_layers)
    load_vae(vae, cfg.vae_ckpt, cfg.seed)
    vae.to(device).eval().requires_grad_(False)

    if cfg.cache_latents:
        train_ds = cache_moments(vae, train_ds, cfg.batch_size, device)
        print(f"cached VAE moments for {len(train_ds)} images")
        train_step = graphed(cfg, make_denoiser_train_step_cached(
            device=device))
    else:
        image_step = make_denoiser_train_step(vae, device=device)

        def batch_step(state, batch, **draws):
            return image_step(state, batch["image"], **draws)

        train_step = graphed(cfg, batch_step)
    train_loader = Loader(train_ds, cfg.batch_size, shuffle=True,
                          seed=cfg.seed, **shard())

    total_steps = len(train_loader) * cfg.num_epochs
    state = TrainState.create(
        denoiser, functools.partial(adamw_cosine, base_lr=cfg.lr,
                                    warmup_steps=cfg.warmup_steps,
                                    total_steps=total_steps,
                                    accumulate_steps=cfg.accum_steps,
                                    capturable=cfg.cuda_graphs),
        ema_decay=cfg.ema_decay, device=device, group=group)
    ckpt = CheckpointManager(os.path.join(cfg.ckpt_dir, cfg.name))
    start_epoch = resume(cfg, ckpt, state, train_loader)
    evaluated = EvalModule(state)
    sampler = build_unconditional_sampler(
        evaluated.module, vae, latent_size=latent, batch=cfg.sample_size,
        device=device)

    logger = MetricsLogger(cfg.log_dir, "hifi_denoiser", cfg.name,
                           use_wandb=cfg.use_wandb)
    timer = StepTimer()
    step = state.step
    for epoch in range(start_epoch, cfg.num_epochs):
        losses = []
        for batch in device_prefetch(train_loader, device):
            state, metrics = train_step(
                state, batch,
                generator=seeded_generator(cfg.seed, step, device))
            timer.tick()
            losses.append(float(metrics["loss"]))
            logger.log({"train_loss": metrics["loss"],
                        "avg_train_loss": float(np.mean(losses)),
                        "step_time": timer.mean, "epoch": epoch}, step)
            step += 1

        if epoch % cfg.save_model_epoch == 0 or epoch == cfg.num_epochs - 1:
            ckpt.save(step, state)
        if is_main_process() and (epoch % cfg.save_image_epoch == 0
                                  or epoch == cfg.num_epochs - 1):
            evaluated()
            grid = sampler(generator=seeded_generator(
                cfg.seed, 10_000 + epoch, device))
            save_image_grid(grid.cpu().numpy(),
                            os.path.join(cfg.out_dir, cfg.name,
                                         f"{epoch}.png"))
    logger.close()


if __name__ == "__main__":
    main()
