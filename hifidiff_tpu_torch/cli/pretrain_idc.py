"""Stage-2 IDC pretraining CLI (counterpart of
hifidiff_tpu/cli/pretrain_idc.py, the reference's `pretrain_idc.py`).

Defaults mirror the reference constants (`pretrain_idc.py:80-83`): Adam lr
5e-4, batch 24, 24 epochs; anchor = IDC(CR(lr)) with a frozen stage-1 CR,
positive = IDC(another photo of the identity), negative = IDC(another
person); triplet margin loss. The IDC's BatchNorms update their running
statistics as flax does (`nn.layers.BatchNorm2d`). The val loss is the mean
over the val set in eval mode.

`--resume` continues at the checkpoint's epoch and stops at `--num-epochs`
(the JAX CLI trains `num_epochs` more epochs after a resume, ROADMAP §C).

It runs on one device, the card unless `--device cpu`, on `--synthetic N` or
`--procedural N` data, or on the Multi-PIE PNG tree of `--dataroot`
(`data/multipie.MultiPIEIDCDataset`, its train and test splits).

    python -m hifidiff_tpu_torch.cli.pretrain_idc \
        --cr-ckpt checkpoints/cr/temp --procedural 96
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from hifidiff_tpu_torch.cli.common import (build_cr, data_parallel, graphed,
                                           load_weights, parse_config,
                                           parse_ints, require_data, resume,
                                           seeded, shard, smoke_datasets)
from hifidiff_tpu_torch.parallel.distributed import global_means
from hifidiff_tpu_torch.data.core import Loader
from hifidiff_tpu_torch.data.multipie import MultiPIEIDCDataset
from hifidiff_tpu_torch.parallel.mesh import device_prefetch, to_device
from hifidiff_tpu_torch.models.idc import IDCEncoder
from hifidiff_tpu_torch.train.checkpoint import CheckpointManager
from hifidiff_tpu_torch.train.losses import triplet_margin_loss
from hifidiff_tpu_torch.train.optim import adam
from hifidiff_tpu_torch.train.steps import TrainState, make_idc_train_step
from hifidiff_tpu_torch.utils.logging import MetricsLogger, StepTimer

# "pos" = a different photo of the identity (the procedural family; a real
# dataset's gt already is one)
KEYS = ("lr", "pos", "other")


@dataclasses.dataclass
class Config:
    name: str = "temp"
    log_dir: str = "logs"
    dataroot: str = ""          # Multi-PIE (PNG)
    cr_ckpt: str = ""
    num_epochs: int = 24
    batch_size: int = 24
    lr: float = 5e-4
    size: int = 128
    cr_width: int = 32
    cr_enc_depths: str = "2,2,4,8"
    cr_mid_depth: int = 8
    idc_stages: str = "3,4,6,3"
    seed: int = 0
    synthetic: int = 0
    procedural: int = 0
    proc_id_spread: float = 1.0   # <1: hard-identity family
    proc_light_jitter: float = 0.0  # >0: per-sample input lighting nuisance
    proc_detail: float = 0.0    # >0: per-identity facial-mark detail
    proc_clutter: int = 0       # >0: per-sample background shapes
    save_epoch: int = 5
    ckpt_dir: str = "checkpoints/idc"
    use_wandb: bool = False
    resume: bool = False
    device: str = "cuda"        # "cpu" only when asked for
    cuda_graphs: bool = False   # capture the train step (the card only)


def frozen_cr(cfg, device):
    """The stage-1 CR of cfg's size flags with the weights of `cr_ckpt`
    (random init with a warning without one), frozen, in eval mode."""
    with seeded(cfg.seed):
        cr = build_cr(cfg.cr_width, cfg.size, cfg.cr_enc_depths,
                      cfg.cr_mid_depth)
    load_weights(cr, cfg.cr_ckpt, "CR")
    return cr.to(device).eval().requires_grad_(False)


def embeddings(cr, idc, batch):
    """IDC(CR(lr)), IDC(pos or gt), IDC(other) of a batch on the device, in
    eval mode, without gradient."""
    with torch.no_grad():
        idc.eval()
        positive = batch["pos"] if "pos" in batch else batch["gt"]
        return idc(cr(batch["lr"])), idc(positive), idc(batch["other"])


def main(argv=None) -> None:
    cfg = parse_config(Config, argv, "Stage-2 IDC pretraining")
    require_data(cfg, ("dataroot",))
    device, group = data_parallel(cfg, "pretrain_idc")
    train_ds, val_ds = smoke_datasets(cfg, KEYS) or (
        MultiPIEIDCDataset(cfg.dataroot, split=split, size=cfg.size,
                           seed=cfg.seed) for split in ("train", "test"))
    train_loader = Loader(train_ds, cfg.batch_size, shuffle=True,
                          seed=cfg.seed, **shard())
    val_loader = Loader(val_ds, cfg.batch_size, shuffle=False, **shard())

    cr = frozen_cr(cfg, device)
    with seeded(cfg.seed):
        idc = IDCEncoder(stage_sizes=parse_ints(cfg.idc_stages))
    state = TrainState.create(idc, functools.partial(
        adam, lr=cfg.lr, capturable=cfg.cuda_graphs),
                              device=device, group=group)
    ckpt = CheckpointManager(os.path.join(cfg.ckpt_dir, cfg.name))
    start_epoch = resume(cfg, ckpt, state, train_loader)
    train_step = graphed(cfg, make_idc_train_step(cr, device=device))

    logger = MetricsLogger(cfg.log_dir, "hifi_idc", cfg.name,
                           use_wandb=cfg.use_wandb)
    timer = StepTimer()
    step = state.step
    for epoch in range(start_epoch, cfg.num_epochs):
        for batch in device_prefetch(train_loader, device):
            state, metrics = train_step(state, batch)
            timer.tick()
            logger.log({"train_loss": metrics["loss"],
                        "step_time": timer.mean, "epoch": epoch}, step)
            step += 1
        val_losses = [global_means({"loss": float(triplet_margin_loss(
            *embeddings(cr, state.module, to_device(b, device))))},
            len(b["lr"]), group)["loss"] for b in val_loader]
        logger.log({"val_loss": float(np.mean(val_losses))}, step)
        if epoch % cfg.save_epoch == 0 or epoch == cfg.num_epochs - 1:
            ckpt.save(step, state)
    logger.close()


if __name__ == "__main__":
    main()
