"""Tiny-denoiser width distillation CLI (counterpart of
hifidiff_tpu/cli/train_tiny_dn.py; experimental, as there: the JAX package
measured the swap 2 dB under the full denoiser at 10 steps,
TINY_DN_QUALITY.json).

Distills a trained full-width FacialRefiner (`--refiner-ckpt`, with
`--cr-ckpt` and `--vae-ckpt`: files or the stage CLIs' checkpoint
directories, read by `cli/common.load_refiner_stack`) into a narrower
FacialRefiner student (`--tiny-width`, depths from `--tiny-*-depths` or the
teacher's) that matches the teacher's epsilon at the points of its DDIM
rollout and at forward-diffused ones (`train/distill.
make_tiny_dn_train_step`). The student's IDC, whose architecture the
teacher shares, starts from the teacher's weights and statistics. AdamW +
cosine over `len(loader) * num_epochs` steps. After every epoch the val
loss is the step's on-policy loss on the val set without an update, every
batch with the noise of `seeded_generator(seed + 1, 0)`; step n draws from
`seeded_generator(seed, n)`.

Checkpoints are `step_<n>.pt` files under `--ckpt-dir/--name` holding the
whole student, which `test_refiner` and `serve` load with `--refiner-ckpt`
and `--width` set to the student's.

It runs on one device, the card unless `--device cpu`, on `--synthetic N` or
`--procedural N` data, or on `--dataroot` (Multi-PIE: the train split
through the blind branch, the test split without, as the JAX CLI builds
them).

    python -m hifidiff_tpu_torch.cli.train_tiny_dn --procedural 64 \
        --refiner-ckpt ... --cr-ckpt ... --vae-ckpt ... --tiny-width 64
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

from hifidiff_tpu_torch.cli.common import (data_parallel, graphed,
                                           load_refiner_stack,
                                           multipie_datasets, parse_config,
                                           parse_ints, require_data, resume,
                                           seeded, seeded_generator, shard,
                                           smoke_datasets)
from hifidiff_tpu_torch.data.core import Loader
from hifidiff_tpu_torch.parallel.mesh import device_prefetch, to_device
from hifidiff_tpu_torch.models.refiner import FacialRefiner
from hifidiff_tpu_torch.train.checkpoint import CheckpointManager
from hifidiff_tpu_torch.train.distill import make_tiny_dn_train_step
from hifidiff_tpu_torch.train.optim import adamw_cosine
from hifidiff_tpu_torch.train.steps import TrainState
from hifidiff_tpu_torch.utils.logging import MetricsLogger, StepTimer


@dataclasses.dataclass
class Config:
    name: str = "temp"
    log_dir: str = "logs"
    dataroot: str = ""          # Multi-PIE (train split: blind)
    model_type: str = "uni"
    num_epochs: int = 100
    batch_size: int = 16
    lr: float = 3e-4
    warmup_steps: int = 200
    rollout_steps: int = 10   # teacher DDIM rollout length (on-policy grid)
    fwd_weight: float = 0.5   # forward-diffused dense-t term weight
    size: int = 128
    # frozen TEACHER stack (same knobs as test_refiner / serve)
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
    refiner_ckpt: str = ""
    cr_ckpt: str = ""
    vae_ckpt: str = ""
    # STUDENT architecture (a narrower FacialRefiner; its IDC is the
    # teacher's architecture, seeded from the teacher's weights)
    tiny_width: int = 64
    tiny_enc_depths: str = ""   # "" = teacher's enc_depths
    tiny_mid_depth: int = 0     # 0  = teacher's mid_depth
    tiny_dec_depths: str = ""   # "" = teacher's dec_depths
    ema_decay: float = 0.0
    seed: int = 0
    synthetic: int = 0
    procedural: int = 0
    proc_id_spread: float = 1.0   # <1: hard-identity family
    proc_light_jitter: float = 0.0  # >0: per-sample input lighting nuisance
    proc_detail: float = 0.0    # >0: per-identity facial-mark detail
    proc_clutter: int = 0       # >0: per-sample background shapes
    save_model_epoch: int = 10
    out_dir: str = "output/tiny_dn"
    ckpt_dir: str = "checkpoints/tiny_dn"
    use_wandb: bool = False
    resume: bool = False
    device: str = "cuda"        # "cpu" only when asked for
    cuda_graphs: bool = False   # capture the train step (the card only)


def build_student(cfg, latent: int, teacher: FacialRefiner) -> FacialRefiner:
    """The narrower FacialRefiner of cfg's `tiny_*` knobs, drawn from
    `cfg.seed`, its IDC's weights and statistics copied from the
    teacher's."""
    with seeded(cfg.seed):
        student = FacialRefiner(
            latent_size=latent, width=cfg.tiny_width,
            enc_nums=parse_ints(cfg.tiny_enc_depths or cfg.enc_depths),
            mid_num=cfg.tiny_mid_depth or cfg.mid_depth,
            dec_nums=parse_ints(cfg.tiny_dec_depths or cfg.dec_depths),
            idc_stage_sizes=parse_ints(cfg.idc_stages))
    student.idc.load_state_dict(teacher.idc.state_dict())
    return student


def main(argv=None) -> None:
    cfg = parse_config(Config, argv, "Tiny-denoiser width distillation")
    require_data(cfg, ("dataroot",))
    device, group = data_parallel(cfg, "train_tiny_dn")
    train_ds, val_ds = (smoke_datasets(cfg, ("lr", "gt"))
                        or multipie_datasets(cfg))
    train_loader = Loader(train_ds, cfg.batch_size, shuffle=True,
                          seed=cfg.seed, **shard())
    val_loader = Loader(val_ds, cfg.batch_size, shuffle=False, **shard())

    cr, vae, teacher, latent = load_refiner_stack(cfg, device)
    teacher.requires_grad_(False)
    student = build_student(cfg, latent, teacher)
    total_steps = len(train_loader) * cfg.num_epochs
    state = TrainState.create(
        student, functools.partial(adamw_cosine, base_lr=cfg.lr,
                                   warmup_steps=cfg.warmup_steps,
                                   total_steps=total_steps,
                                   capturable=cfg.cuda_graphs),
        ema_decay=cfg.ema_decay, device=device, group=group)
    ckpt = CheckpointManager(os.path.join(cfg.ckpt_dir, cfg.name))
    start_epoch = resume(cfg, ckpt, state, train_loader)
    eager_step = make_tiny_dn_train_step(
        cr, vae, rollout_steps=cfg.rollout_steps, fwd_weight=cfg.fwd_weight,
        device=device)
    train_step = graphed(cfg, eager_step)

    logger = MetricsLogger(cfg.log_dir, "hifi_tiny_dn", cfg.name,
                           use_wandb=cfg.use_wandb)
    timer = StepTimer()
    step = state.step
    for epoch in range(start_epoch, cfg.num_epochs):
        for batch in device_prefetch(train_loader, device):
            state, metrics = train_step(
                state, teacher, batch,
                generator=seeded_generator(cfg.seed, step, device))
            timer.tick()
            logger.log({"train_loss": metrics["loss"],
                        "onpolicy_loss": metrics["onpolicy_loss"],
                        "fwd_loss": metrics["fwd_loss"],
                        "step_time": timer.mean, "epoch": epoch}, step)
            step += 1

        # val: the distillation objective on held-out poses, the same draws
        # every batch and epoch
        losses = []
        for batch in val_loader:
            _, metrics = eager_step(
                state, teacher, to_device(batch, device), update=False,
                generator=seeded_generator(cfg.seed + 1, 0, device))
            losses.append(float(metrics["onpolicy_loss"]))
        logger.log({"val_onpolicy_loss": float(np.mean(losses))}, step)

        if epoch % cfg.save_model_epoch == 0 or epoch == cfg.num_epochs - 1:
            ckpt.save(step, state)
    logger.close()


if __name__ == "__main__":
    main()
