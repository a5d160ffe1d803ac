"""Stage-1 CR training CLI (counterpart of hifidiff_tpu/cli/train_cr.py, the
reference's `train_cr.py`).

Defaults mirror the reference flags (`train_cr.py:15-48`): 24 epochs, Adam
lr 5e-4, batch 8, cr_loss = MSE + key-region MSE, `[lr | pred | gt]` grids
every `dump_every` batches, a checkpoint every 5 epochs. `--loss composite`
is the reference's optional CRLoss (smooth-L1 + key-region smooth-L1 +
SSIM), with its VGG term when `--lambda-vgg > 0` and `--vgg19-ckpt` (a
torchvision vgg19 state dict, torch file or `.safetensors`) are given: the
smooth-L1 between `eval/vgg.py`'s relu4_2 features of prediction and target,
both taken without gradient as the reference takes them, so that the term
adds to the loss and nothing to the gradient.

It runs on one device, the card unless `--device cpu`, on `--synthetic N` or
`--procedural N` data, or on `--dataroot` (Multi-PIE: the train split
through the blind branch, the test split without, as the JAX CLI builds
them).

    python -m hifidiff_tpu_torch.cli.train_cr --procedural 64
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

from hifidiff_tpu_torch.cli.common import (build_cr, data_parallel, graphed,
                                           multipie_datasets, parse_config,
                                           read_state_dict, require_data,
                                           resume, seeded, shard,
                                           smoke_datasets, to_nhwc)
from hifidiff_tpu_torch.parallel.distributed import global_means
from hifidiff_tpu_torch.data.core import Loader
from hifidiff_tpu_torch.parallel.mesh import device_prefetch, to_device
from hifidiff_tpu_torch.eval.vgg import make_vgg_features_fn
from hifidiff_tpu_torch.train.checkpoint import CheckpointManager
from hifidiff_tpu_torch.train.losses import composite_cr_loss
from hifidiff_tpu_torch.train.optim import adam
from hifidiff_tpu_torch.train.steps import (TrainState, make_cr_eval_step,
                                            make_cr_train_step)
from hifidiff_tpu_torch.utils.logging import (MetricsLogger, StepTimer,
                                              save_image_grid, side_by_side)


@dataclasses.dataclass
class Config:
    name: str = "temp"
    log_dir: str = "logs"
    dataroot: str = ""          # Multi-PIE (train split: blind)
    model_type: str = "uni"
    num_epochs: int = 24
    batch_size: int = 8
    lr: float = 5e-4
    size: int = 128
    width: int = 32
    enc_depths: str = "2,2,4,8"
    mid_depth: int = 8
    # loss: "cr" = MSE + key-region (reference default, `train_cr.py:178`);
    # "composite" = the reference's optional CRLoss (`loss.py:8-67`)
    loss: str = "cr"
    lambda_pix: float = 1.0
    lambda_ssim: float = 0.0
    lambda_vgg: float = 0.0
    vgg19_ckpt: str = ""   # torchvision vgg19 state_dict for the VGG term
    seed: int = 0
    synthetic: int = 0          # >0: use N synthetic samples (smoke mode)
    procedural: int = 0         # >0: N learnable procedural faces (demo)
    proc_id_spread: float = 1.0   # <1: hard-identity family
    proc_light_jitter: float = 0.0  # >0: per-sample input lighting nuisance
    proc_detail: float = 0.0    # >0: per-identity facial-mark detail
    proc_clutter: int = 0       # >0: per-sample background shapes
    save_epoch: int = 5
    dump_every: int = 100
    out_dir: str = "output/cr"
    ckpt_dir: str = "checkpoints/cr"
    use_wandb: bool = False
    resume: bool = False
    device: str = "cuda"        # "cpu" only when asked for
    cuda_graphs: bool = False   # capture the train step (the card only)


def main(argv=None) -> None:
    cfg = parse_config(Config, argv, "Stage-1 CR training")
    require_data(cfg, ("dataroot",))
    if cfg.loss not in ("cr", "composite"):
        raise ValueError(f"--loss must be 'cr' or 'composite', got "
                         f"{cfg.loss!r}")
    device, group = data_parallel(cfg, "train_cr")
    train_ds, val_ds = (smoke_datasets(cfg, ("lr", "gt", "patches"))
                        or multipie_datasets(cfg, use_patch=True))
    train_loader = Loader(train_ds, cfg.batch_size, shuffle=True,
                          seed=cfg.seed, **shard())
    val_loader = Loader(val_ds, cfg.batch_size, shuffle=False, **shard())

    with seeded(cfg.seed):
        model = build_cr(cfg.width, cfg.size, cfg.enc_depths, cfg.mid_depth)
    state = TrainState.create(model, functools.partial(
        adam, lr=cfg.lr, capturable=cfg.cuda_graphs),
                              device=device, group=group)
    ckpt = CheckpointManager(os.path.join(cfg.ckpt_dir, cfg.name))
    start_epoch = resume(cfg, ckpt, state, train_loader)

    loss_fn = None
    if cfg.loss == "composite":
        vgg_fn = None
        if cfg.lambda_vgg > 0 and cfg.vgg19_ckpt:
            vgg_fn = make_vgg_features_fn(read_state_dict(cfg.vgg19_ckpt),
                                          device)
        loss_fn = functools.partial(
            composite_cr_loss, lambda_pix=cfg.lambda_pix,
            lambda_ssim=cfg.lambda_ssim, lambda_vgg=cfg.lambda_vgg,
            vgg_features_fn=vgg_fn)
    train_step = graphed(cfg, make_cr_train_step(loss_fn, device=device))
    eval_step = make_cr_eval_step(device=device)

    def dump(batch, pred, kind, epoch, i):
        save_image_grid(
            side_by_side(to_nhwc(batch["lr"]), to_nhwc(pred),
                         to_nhwc(batch["gt"])),
            os.path.join(cfg.out_dir, cfg.name, f"{kind}_e{epoch}_b{i}.png"))

    logger = MetricsLogger(cfg.log_dir, "hifi_cr", cfg.name,
                           use_wandb=cfg.use_wandb)
    timer = StepTimer()
    step = state.step
    for epoch in range(start_epoch, cfg.num_epochs):
        for i, on_device in enumerate(device_prefetch(train_loader, device)):
            state, metrics = train_step(state, on_device)
            timer.tick()
            logger.log({"train_loss": metrics["loss"],
                        "step_time": timer.mean, "epoch": epoch}, step)
            if cfg.dump_every and i % cfg.dump_every == 0:
                dump(on_device, eval_step(state.module, on_device)[0],
                     "train", epoch, i)
            step += 1

        val_losses = []
        for i, batch in enumerate(val_loader):
            batch = to_device(batch, device)
            pred, m = eval_step(state.module, batch)
            val_losses.append(global_means(
                {"loss": float(m["loss"])}, len(pred), group)["loss"])
            if cfg.dump_every and i % cfg.dump_every == 0:
                dump(batch, pred, "val", epoch, i)
        logger.log({"val_loss": float(np.mean(val_losses))}, step)

        if epoch % cfg.save_epoch == 0 or epoch == cfg.num_epochs - 1:
            ckpt.save(step, state)
    logger.close()


if __name__ == "__main__":
    main()
