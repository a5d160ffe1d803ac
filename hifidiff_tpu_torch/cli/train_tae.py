"""Tiny-autoencoder distillation CLI (counterpart of
hifidiff_tpu/cli/train_tae.py).

Distills the frozen SD VAE (`--vae-ckpt`: a diffusers state dict or a
`train_vae` checkpoint directory) into the tiny encoder / decoder pair of
`vae/tiny.py` (`train/distill.make_tae_train_step`): AdamW + cosine over
`len(loader) * num_epochs` steps, the tiny pair drawn as the JAX CLI's flax
init draws it. `--extra-latents` (an `.npz` with "z" (N, h, w, 4), unscaled
latents the sampler produced) adds the on-policy decoder term, a random
draw of them each step. After every epoch: the val set's end-to-end tiny
PSNR and the tiny decoder's PSNR against the teacher's on the posterior
mean, and a `[input | recon]` grid. Step n draws its posterior noise from
`seeded_generator(seed, n)`.

Checkpoints are `step_<n>.pt` files under `--ckpt-dir/--name`; their module
names (`enc.` / `dec.`) are what `test_refiner --tae-ckpt` and `serve
--tae-ckpt` load (`cli/common.load_tiny_seams`).

It runs on one device, the card unless `--device cpu`, on `--synthetic N` or
`--procedural N` data, or on the images of `--multipie-root` (a Multi-PIE
tree's train split) and `--celeba-root` (a flat directory of PNG, JPEG,
WebP and BMP files).

    python -m hifidiff_tpu_torch.cli.train_tae --procedural 64 \
        --vae-ckpt checkpoints/vae/temp
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch
from torch import nn

from hifidiff_tpu_torch.cli.common import (EvalModule, data_parallel, graphed,
                                           hq_datasets, load_vae, parse_config,
                                           parse_ints, require_data, resume,
                                           seeded, seeded_generator, shard,
                                           smoke_datasets, to_nhwc)
from hifidiff_tpu_torch.parallel.distributed import global_means
from hifidiff_tpu_torch.data.core import Loader
from hifidiff_tpu_torch.parallel.mesh import device_prefetch, to_device
from hifidiff_tpu_torch.train.checkpoint import CheckpointManager
from hifidiff_tpu_torch.train.distill import make_tae_train_step
from hifidiff_tpu_torch.train.optim import adamw_cosine
from hifidiff_tpu_torch.train.steps import TrainState
from hifidiff_tpu_torch.utils.logging import (MetricsLogger, StepTimer,
                                              save_image_grid, side_by_side)
from hifidiff_tpu_torch.vae.model import AutoencoderKL, flax_default_init_
from hifidiff_tpu_torch.vae.tiny import tiny_autoencoder_pair


@dataclasses.dataclass
class Config:
    name: str = "temp"
    log_dir: str = "logs"
    multipie_root: str = ""    # PNG
    celeba_root: str = ""      # PNG
    num_epochs: int = 100
    batch_size: int = 64
    lr: float = 3e-4
    warmup_steps: int = 200
    gt_weight: float = 0.3   # weight of the direct-recon term vs teacher
    extra_latents: str = ""  # .npz with "z" (N,h,w,4) UNSCALED latents
    # from the diffusion sampler: the on-policy decoder term
    size: int = 128
    # frozen teacher (architecture + checkpoint)
    vae_blocks: str = "128,256,512,512"
    vae_layers: int = 2
    vae_ckpt: str = ""
    ema_decay: float = 0.0
    seed: int = 0
    synthetic: int = 0
    procedural: int = 0
    proc_id_spread: float = 1.0   # <1: hard-identity family
    proc_light_jitter: float = 0.0  # >0: per-sample input lighting nuisance
    proc_detail: float = 0.0    # >0: per-identity facial-mark detail
    proc_clutter: int = 0       # >0: per-sample background shapes
    save_model_epoch: int = 10
    save_image_epoch: int = 10
    out_dir: str = "output/tae"
    ckpt_dir: str = "checkpoints/tae"
    use_wandb: bool = False
    resume: bool = False
    device: str = "cuda"        # "cpu" only when asked for
    cuda_graphs: bool = False   # capture the train step (the card only)


def _db(mse: float) -> float:
    return -10.0 * math.log10(max(mse, 1e-12))


@torch.no_grad()
def recon(pair: nn.Module, vae: AutoencoderKL, images: torch.Tensor,
          group=None):
    """The tiny pair's reconstruction of [0, 1] images (B, 3, H, W) in
    [0, 1], its PSNR against them, and the PSNR of the tiny decoder against
    the teacher's on the teacher's posterior mean, both clipped to [0, 1]
    (with a data-parallel `group`, of the global batch's mean squared
    errors)."""
    x01 = images.clamp(0.0, 1.0)
    x = x01 * 2.0 - 1.0
    rec01 = (pair["dec"](pair["enc"](x)) * 0.5 + 0.5).clamp(0.0, 1.0)
    z = vae.encode(x)
    teacher = (vae.decode(z) * 0.5 + 0.5).clamp(0.0, 1.0)
    student = (pair["dec"](z) * 0.5 + 0.5).clamp(0.0, 1.0)
    mse = global_means(
        {"rec": float((rec01 - x01).square().mean()),
         "dec": float((student - teacher).square().mean())},
        len(images), group)
    return rec01, _db(mse["rec"]), _db(mse["dec"])


def main(argv=None) -> None:
    cfg = parse_config(Config, argv, "Tiny-autoencoder distillation")
    require_data(cfg, ("multipie_root", "celeba_root"))
    device, group = data_parallel(cfg, "train_tae")
    # the real data's train and val sets are one, as the JAX CLI has them
    train_ds, val_ds = smoke_datasets(cfg, ("image",)) or (
        hq_datasets(cfg),) * 2
    train_loader = Loader(train_ds, cfg.batch_size, shuffle=True,
                          seed=cfg.seed, **shard())
    val_loader = Loader(val_ds, cfg.batch_size, shuffle=False, **shard())

    vae_blocks = parse_ints(cfg.vae_blocks)
    with seeded(cfg.seed):
        vae = AutoencoderKL(block_out=vae_blocks,
                            layers_per_block=cfg.vae_layers)
        # drawn as the JAX CLI's flax init of the tiny pair draws it
        pair = flax_default_init_(nn.ModuleDict(dict(zip(
            ("enc", "dec"), tiny_autoencoder_pair(2 ** (len(vae_blocks)
                                                        - 1))))))
    load_vae(vae, cfg.vae_ckpt, cfg.seed)
    vae.to(device).eval().requires_grad_(False)

    total_steps = len(train_loader) * cfg.num_epochs
    state = TrainState.create(
        pair, functools.partial(adamw_cosine, base_lr=cfg.lr,
                                warmup_steps=cfg.warmup_steps,
                                total_steps=total_steps,
                                capturable=cfg.cuda_graphs),
        ema_decay=cfg.ema_decay, device=device, group=group)
    ckpt = CheckpointManager(os.path.join(cfg.ckpt_dir, cfg.name))
    start_epoch = resume(cfg, ckpt, state, train_loader)
    train_step = graphed(cfg, make_tae_train_step(
        vae, gt_weight=cfg.gt_weight, device=device))
    evaluated = EvalModule(state)

    extra_z = None
    if cfg.extra_latents:
        extra_z = np.load(cfg.extra_latents)["z"].astype(np.float32)
        rng = np.random.default_rng(cfg.seed)
        print(f"on-policy latents: {extra_z.shape} from {cfg.extra_latents}")

    logger = MetricsLogger(cfg.log_dir, "hifi_tae", cfg.name,
                           use_wandb=cfg.use_wandb)
    timer = StepTimer()
    step = state.step
    for epoch in range(start_epoch, cfg.num_epochs):
        def with_extra(loader):
            for batch in loader:
                if extra_z is not None:
                    batch = dict(batch, extra_z=extra_z[rng.integers(
                        0, len(extra_z), size=batch["image"].shape[0])])
                yield batch

        for batch in device_prefetch(with_extra(train_loader), device):
            state, metrics = train_step(
                state, batch,
                generator=seeded_generator(cfg.seed, step, device))
            timer.tick()
            logger.log({"train_loss": metrics["loss"],
                        "dec_loss": metrics["dec_loss"],
                        "enc_loss": metrics["enc_loss"],
                        "step_time": timer.mean, "epoch": epoch}, step)
            step += 1

        psnrs, dec_psnrs = [], []
        model = evaluated()
        for i, batch in enumerate(val_loader):
            rec, p, dp = recon(model, vae,
                               to_device(batch, device)["image"], group)
            psnrs.append(p)
            dec_psnrs.append(dp)
            if i == 0 and epoch % cfg.save_image_epoch == 0:
                save_image_grid(
                    side_by_side(batch["image"], to_nhwc(rec)),
                    os.path.join(cfg.out_dir, cfg.name, f"val_e{epoch}.png"))
        logger.log({"val_psnr": float(np.mean(psnrs)),
                    "val_dec_vs_teacher_psnr": float(np.mean(dec_psnrs))},
                   step)

        if epoch % cfg.save_model_epoch == 0 or epoch == cfg.num_epochs - 1:
            ckpt.save(step, state)
    logger.close()


if __name__ == "__main__":
    main()
