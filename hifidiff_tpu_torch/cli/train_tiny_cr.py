"""Tiny-CR distillation CLI (counterpart of hifidiff_tpu/cli/train_tiny_cr.py).

Distills the trained Coarse Restoration net (`--cr-ckpt`: a reference-named
state dict or a `train_cr` checkpoint directory; random with a warning
without one) into the TinyCR student of `models/tiny_cr.py`
(`train/distill.make_tiny_cr_train_step`): AdamW + cosine over
`len(loader) * num_epochs` steps, the student drawn as the JAX CLI's flax
init draws it. After every epoch: the student's PSNR against the teacher
and against the ground truth on the val set, both clipped to [0, 1], and a
`[lr | student | gt]` grid.

Checkpoints are `step_<n>.pt` files under `--ckpt-dir/--name`, the TinyCR's
own names, which `test_refiner --tiny-cr-ckpt` and `serve --tiny-cr-ckpt`
load (`cli/common.load_tiny_seams`).

It runs on one device, the card unless `--device cpu`, on `--synthetic N` or
`--procedural N` data, or on `--dataroot` (Multi-PIE: the train split
through the blind branch, the test split without, as the JAX CLI builds
them).

    python -m hifidiff_tpu_torch.cli.train_tiny_cr --procedural 64 \
        --cr-ckpt checkpoints/cr/temp
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch

from hifidiff_tpu_torch.cli.common import (EvalModule, build_cr, data_parallel,
                                           graphed, load_weights,
                                           multipie_datasets, parse_config,
                                           require_data, resume, seeded, shard,
                                           smoke_datasets, to_nhwc)
from hifidiff_tpu_torch.parallel.distributed import global_means
from hifidiff_tpu_torch.data.core import Loader
from hifidiff_tpu_torch.parallel.mesh import device_prefetch, to_device
from hifidiff_tpu_torch.models.tiny_cr import TinyCR
from hifidiff_tpu_torch.train.checkpoint import CheckpointManager
from hifidiff_tpu_torch.train.distill import make_tiny_cr_train_step
from hifidiff_tpu_torch.train.optim import adamw_cosine
from hifidiff_tpu_torch.train.steps import TrainState
from hifidiff_tpu_torch.utils.logging import (MetricsLogger, StepTimer,
                                              save_image_grid, side_by_side)
from hifidiff_tpu_torch.vae.model import flax_default_init_


@dataclasses.dataclass
class Config:
    name: str = "temp"
    log_dir: str = "logs"
    dataroot: str = ""          # Multi-PIE (train split: blind)
    model_type: str = "uni"
    num_epochs: int = 100
    batch_size: int = 64
    lr: float = 3e-4
    warmup_steps: int = 200
    gt_weight: float = 0.3   # weight of the direct-GT term vs teacher
    size: int = 128
    # frozen teacher (architecture + checkpoint)
    cr_width: int = 32
    cr_enc_depths: str = "2,2,4,8"
    cr_mid_depth: int = 8
    cr_ckpt: str = ""
    # student architecture (models/tiny_cr.py)
    tiny_width: int = 64
    tiny_blocks: int = 4
    tiny_down: int = 2
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
    out_dir: str = "output/tiny_cr"
    ckpt_dir: str = "checkpoints/tiny_cr"
    use_wandb: bool = False
    resume: bool = False
    device: str = "cuda"        # "cpu" only when asked for
    cuda_graphs: bool = False   # capture the train step (the card only)


def _db(mse: float) -> float:
    return -10.0 * math.log10(max(mse, 1e-12))


def main(argv=None) -> None:
    cfg = parse_config(Config, argv, "Tiny-CR distillation")
    require_data(cfg, ("dataroot",))
    device, group = data_parallel(cfg, "train_tiny_cr")
    train_ds, val_ds = (smoke_datasets(cfg, ("lr", "gt"))
                        or multipie_datasets(cfg))
    train_loader = Loader(train_ds, cfg.batch_size, shuffle=True,
                          seed=cfg.seed, **shard())
    val_loader = Loader(val_ds, cfg.batch_size, shuffle=False, **shard())

    with seeded(cfg.seed):
        cr = build_cr(cfg.cr_width, cfg.size, cfg.cr_enc_depths,
                      cfg.cr_mid_depth)
        tiny = flax_default_init_(TinyCR(width=cfg.tiny_width,
                                         blocks=cfg.tiny_blocks,
                                         down_factor=cfg.tiny_down))
    load_weights(cr, cfg.cr_ckpt, "CR teacher")
    cr.to(device).eval().requires_grad_(False)

    total_steps = len(train_loader) * cfg.num_epochs
    state = TrainState.create(
        tiny, functools.partial(adamw_cosine, base_lr=cfg.lr,
                                warmup_steps=cfg.warmup_steps,
                                total_steps=total_steps,
                                capturable=cfg.cuda_graphs),
        ema_decay=cfg.ema_decay, device=device, group=group)
    ckpt = CheckpointManager(os.path.join(cfg.ckpt_dir, cfg.name))
    start_epoch = resume(cfg, ckpt, state, train_loader)
    train_step = graphed(cfg, make_tiny_cr_train_step(
        cr, gt_weight=cfg.gt_weight, device=device))
    evaluated = EvalModule(state)

    logger = MetricsLogger(cfg.log_dir, "hifi_tiny_cr", cfg.name,
                           use_wandb=cfg.use_wandb)
    timer = StepTimer()
    step = state.step
    for epoch in range(start_epoch, cfg.num_epochs):
        for batch in device_prefetch(train_loader, device):
            state, metrics = train_step(state, batch)
            timer.tick()
            logger.log({"train_loss": metrics["loss"],
                        "teacher_loss": metrics["teacher_loss"],
                        "gt_loss": metrics["gt_loss"],
                        "step_time": timer.mean, "epoch": epoch}, step)
            step += 1

        t_psnrs, g_psnrs = [], []
        model = evaluated()
        for i, batch in enumerate(val_loader):
            on = to_device(batch, device)
            with torch.no_grad():
                out = model(on["lr"]).clamp(0.0, 1.0)
                teacher = cr(on["lr"]).clamp(0.0, 1.0)
            mse = global_means(
                {"teacher": float((out - teacher).square().mean()),
                 "gt": float((out - on["gt"]).square().mean())},
                len(out), group)
            t_psnrs.append(_db(mse["teacher"]))
            g_psnrs.append(_db(mse["gt"]))
            if i == 0 and epoch % cfg.save_image_epoch == 0:
                save_image_grid(
                    side_by_side(batch["lr"], to_nhwc(out), batch["gt"]),
                    os.path.join(cfg.out_dir, cfg.name, f"val_e{epoch}.png"))
        logger.log({"val_vs_teacher_psnr": float(np.mean(t_psnrs)),
                    "val_vs_gt_psnr": float(np.mean(g_psnrs))}, step)

        if epoch % cfg.save_model_epoch == 0 or epoch == cfg.num_epochs - 1:
            ckpt.save(step, state)
    logger.close()


if __name__ == "__main__":
    main()
