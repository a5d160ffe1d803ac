"""Stage-4 full-pipeline refiner training CLI (counterpart of
hifidiff_tpu/cli/train_refiner.py, the reference's `train_refiner.py`).

Composition per `models/refiner.py:10-30` and `train_refiner.py:302-431`:
FacialRefiner (IDC + FusedDenoiser + FPG) with the IDC's weights from stage
2 and the denoiser's and FPG's from stage 3 (`train/checkpoint.
compose_refiner`, an overlay by name and shape); the IDC and the denoiser's
intro and encoder stages frozen (`optim.refiner_freeze_mask`); a frozen
stage-1 CR and a frozen VAE feed the conditioning. AdamW + cosine over
`len(loader) * num_epochs` steps. After every epoch the val set runs through
the split DDIM sampler (`num_inference_steps`, float images) and PSNR / SSIM
with the reference's eval conventions, and its first batch is written as a
`[lr | pred | gt]` grid. Step n draws its noise from `seeded_generator(seed,
n)`, val batch i from `seeded_generator(seed, 50_000 + i)`.

`--stop-after-epoch k` checkpoints and stops after epoch k; `--resume` with
the same `--num-epochs` continues where it stopped, with the uninterrupted
run's schedule and shuffles (the JAX CLI restarts its shuffles at epoch 0,
ROADMAP §C).

It runs on one device, the card unless `--device cpu`, on `--synthetic N` or
`--procedural N` data, or on `--dataroot` (Multi-PIE: the train split
through the blind branch, the test split without, as the JAX CLI builds
them).

    python -m hifidiff_tpu_torch.cli.train_refiner --procedural 64 \
        --vae-ckpt ... --cr-ckpt ... --idc-ckpt ... --denoiser-ckpt ...
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from hifidiff_tpu_torch.cli.common import (EvalModule, build_refiner_models,
                                           data_parallel, graphed, load_vae,
                                           load_weights, multipie_datasets,
                                           parse_config, read_state_dict,
                                           require_data, resume, sampler_noise,
                                           seeded_generator, shard,
                                           smoke_datasets)
from hifidiff_tpu_torch.data.core import Loader
from hifidiff_tpu_torch.parallel.mesh import device_prefetch
from hifidiff_tpu_torch.eval.metrics import reference_eval_metrics
from hifidiff_tpu_torch.pipeline import (RefinerPipelineConfig,
                                         build_refiner_sampler_split)
from hifidiff_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 compose_refiner)
from hifidiff_tpu_torch.train.optim import (adamw_cosine, apply_freeze_mask_,
                                            refiner_freeze_mask)
from hifidiff_tpu_torch.train.steps import TrainState, make_refiner_train_step
from hifidiff_tpu_torch.utils.logging import (MetricsLogger, StepTimer,
                                              save_image_grid, side_by_side)


@dataclasses.dataclass
class Config:
    name: str = "temp"
    log_dir: str = "logs"
    dataroot: str = ""          # Multi-PIE (train split: blind)
    vae_ckpt: str = ""
    cr_ckpt: str = ""
    idc_ckpt: str = ""
    denoiser_ckpt: str = ""
    model_type: str = "uni"
    num_epochs: int = 100
    batch_size: int = 32
    lr: float = 1e-4
    warmup_steps: int = 500
    accum_steps: int = 1
    size: int = 128
    num_inference_steps: int = 50
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
    remat: bool = False   # checkpoint the UNet blocks (less device memory)
    ema_decay: float = 0.0  # >0: EMA of trainable params for val sampling
    seed: int = 0
    synthetic: int = 0
    procedural: int = 0
    proc_id_spread: float = 1.0   # <1: hard-identity family
    proc_light_jitter: float = 0.0  # >0: per-sample input lighting nuisance
    proc_detail: float = 0.0    # >0: per-identity facial-mark detail
    proc_clutter: int = 0       # >0: per-sample background shapes
    save_epoch: int = 5
    out_dir: str = "output/refiner"
    ckpt_dir: str = "checkpoints/refiner"
    use_wandb: bool = False
    resume: bool = False
    stop_after_epoch: int = -1  # >=0: checkpoint + stop after this epoch
    # (resume with the SAME --num-epochs)
    device: str = "cuda"        # "cpu" only when asked for
    cuda_graphs: bool = False   # capture the train step (the card only)


def compose(cfg, refiner) -> dict:
    """Overlay the stage-2 IDC and the stage-3 denoiser onto the refiner
    (either may be empty); returns the loaded names per submodule."""
    loaded = compose_refiner(
        refiner,
        idc=read_state_dict(cfg.idc_ckpt) if cfg.idc_ckpt else None,
        denoiser=(read_state_dict(cfg.denoiser_ckpt) if cfg.denoiser_ckpt
                  else None))
    print("composed the refiner: " + ", ".join(
        f"{k} {len(v)} tensors" for k, v in loaded.items()))
    return loaded


def main(argv=None) -> None:
    cfg = parse_config(Config, argv, "Stage-4 refiner training")
    require_data(cfg, ("dataroot",))
    device, group = data_parallel(cfg, "train_refiner")
    train_ds, val_ds = (smoke_datasets(cfg, ("lr", "gt"))
                        or multipie_datasets(cfg))
    train_loader = Loader(train_ds, cfg.batch_size, shuffle=True,
                          seed=cfg.seed, **shard())
    val_loader = Loader(val_ds, cfg.batch_size, shuffle=False, **shard())

    # frozen stage-1 CR and VAE; the refiner composed from stages 2 and 3
    cr, vae, refiner, latent = build_refiner_models(cfg)
    load_weights(cr, cfg.cr_ckpt, "CR")
    load_vae(vae, cfg.vae_ckpt, cfg.seed)
    compose(cfg, refiner)
    apply_freeze_mask_(refiner, refiner_freeze_mask(refiner))

    total_steps = len(train_loader) * cfg.num_epochs
    state = TrainState.create(
        refiner, functools.partial(adamw_cosine, base_lr=cfg.lr,
                                   warmup_steps=cfg.warmup_steps,
                                   total_steps=total_steps,
                                   accumulate_steps=cfg.accum_steps,
                                   capturable=cfg.cuda_graphs),
        ema_decay=cfg.ema_decay, device=device, group=group)
    ckpt = CheckpointManager(os.path.join(cfg.ckpt_dir, cfg.name))
    start_epoch = resume(cfg, ckpt, state, train_loader)
    train_step = graphed(cfg, make_refiner_train_step(cr, vae,
                                                      device=device))
    evaluated = EvalModule(state)
    sampler = build_refiner_sampler_split(
        evaluated.module, cr, vae,
        RefinerPipelineConfig(num_inference_steps=cfg.num_inference_steps,
                              latent_size=latent, io_uint8=False),
        device=device)

    logger = MetricsLogger(cfg.log_dir, "hifi_refiner", cfg.name,
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
                        "step_time": timer.mean, "epoch": epoch}, step)
            step += 1

        # validation: full DDIM sampling + metrics (train_refiner.py:212-299)
        psnrs, ssims = [], []
        evaluated()
        for i, batch in enumerate(val_loader):
            lr, gt = (torch.from_numpy(batch[k]).to(device)
                      for k in ("lr", "gt"))   # NHWC, as the sampler takes
            pred = sampler(lr, **sampler_noise(
                sampler, len(lr), seeded_generator(cfg.seed, 50_000 + i,
                                                   device), group))
            m = reference_eval_metrics(pred, gt, group)[0]
            psnrs.append(float(m["psnr"]))
            ssims.append(float(m["ssim"]))
            if i == 0:
                save_image_grid(
                    side_by_side(batch["lr"], pred.float().cpu().numpy(),
                                 batch["gt"]),
                    os.path.join(cfg.out_dir, cfg.name, f"val_e{epoch}.png"))
        logger.log({"val_psnr": float(np.mean(psnrs)),
                    "val_ssim": float(np.mean(ssims))}, step)

        last = (epoch == cfg.num_epochs - 1
                or epoch == cfg.stop_after_epoch)
        if epoch % cfg.save_epoch == 0 or last:
            ckpt.save(step, state)
        if epoch == cfg.stop_after_epoch:
            print(f"stopping after epoch {epoch} (--stop-after-epoch)")
            break
    logger.close()


if __name__ == "__main__":
    main()
