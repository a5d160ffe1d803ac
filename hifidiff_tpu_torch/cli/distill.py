"""Progressive-distillation CLI (counterpart of hifidiff_tpu/cli/distill.py).

Distills a trained refiner's DDIM sampler into a few-step student
(`train/distill.make_distill_train_step`). `--student-steps` is a comma list
of rounds: each round's teacher is the previous round's student (the first
is `--teacher-steps`, by default the reference's 50), its sub-step count the
teacher / student ratio: "25" is one halving round, "10" distills 50 -> 10
with 5 sub-steps, "25,5" chains 50 -> 25 -> 5. A round's student starts as
a copy of its teacher and trains `--steps-per-round` steps with AdamW +
cosine (`optim.adamw_cosine`), step n of the run drawing from
`seeded_generator(seed, n)`.

After each round the student is checkpointed (`step_<n>.pt` under
`--ckpt-dir/--name/round<r>_s<steps>`, a whole FacialRefiner that
`--refiner-ckpt` loads) and evaluated on one held-out batch against the
exact teacher sampler at `--teacher-steps`, beside the naive baselines: the
round's teacher and the original weights run at the student's step count.
PSNR against the exact teacher is plain output-space PSNR
(`eval.metrics.psnr`); against the ground truth it takes the reference's
convention (batch min-max normalization, then `psnr_pyiqa`). Every sampler
call draws its noise from `seeded_generator(seed, 10_000)`. Returns the
results dict the JAX CLI returns.

It runs on one device, the card unless `--device cpu`, on `--synthetic N` or
`--procedural N` data, or on `--dataroot` (Multi-PIE: the train split
through the blind branch, the test split without, as the JAX CLI builds
them).

    python -m hifidiff_tpu_torch.cli.distill --refiner-ckpt ... \
        --cr-ckpt ... --vae-ckpt ... --student-steps 10 --procedural 64
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import os

import torch

from hifidiff_tpu_torch.cli.common import (data_parallel, graphed,
                                           load_refiner_stack,
                                           multipie_datasets, parse_config,
                                           parse_ints, require_data,
                                           sampler_noise, seeded_generator,
                                           shard, smoke_datasets)
from hifidiff_tpu_torch.parallel.mesh import to_device
from hifidiff_tpu_torch.data.core import Loader
from hifidiff_tpu_torch.parallel.distributed import gather_rows
from hifidiff_tpu_torch.eval.metrics import (min_max_normalize, psnr,
                                             psnr_pyiqa)
from hifidiff_tpu_torch.pipeline import (RefinerPipelineConfig,
                                         build_refiner_sampler_split)
from hifidiff_tpu_torch.train.checkpoint import CheckpointManager
from hifidiff_tpu_torch.train.distill import make_distill_train_step
from hifidiff_tpu_torch.train.optim import adamw_cosine
from hifidiff_tpu_torch.train.steps import TrainState
from hifidiff_tpu_torch.utils.logging import MetricsLogger


@dataclasses.dataclass
class Config:
    name: str = "temp"
    log_dir: str = "logs"
    dataroot: str = ""          # Multi-PIE (train split: blind)
    model_type: str = "uni"
    # distillation schedule
    teacher_steps: int = 50
    student_steps: str = "10"    # comma list of rounds (see module doc)
    steps_per_round: int = 2000
    stratified: bool = False    # per-batch even step coverage (variance
    # reduction for the truncated-SNR objective; see train/distill.py)
    batch_size: int = 16
    lr: float = 1e-5             # small: the student starts AT the teacher
    warmup_steps: int = 100
    clip_sample_range: float = 3.0  # teacher trajectory = test_refiner's
    # checkpoints (files or checkpoint directories; empty = random init)
    refiner_ckpt: str = ""
    cr_ckpt: str = ""
    vae_ckpt: str = ""
    # model-size knobs (defaults = reference architecture)
    size: int = 128
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
    eval_batch: int = 16
    ckpt_dir: str = "checkpoints/distill"
    use_wandb: bool = False
    device: str = "cuda"        # "cpu" only when asked for
    cuda_graphs: bool = False   # capture the train step (the card only)


def main(argv=None) -> dict:
    cfg = parse_config(Config, argv, "Progressive sampler distillation")
    require_data(cfg, ("dataroot",))
    device, group = data_parallel(cfg, "distill")
    cr, vae, teacher, latent = load_refiner_stack(cfg, device)
    teacher.requires_grad_(False)

    train_ds, val_ds = (smoke_datasets(cfg, ("lr", "gt"))
                        or multipie_datasets(cfg))
    loader = Loader(train_ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                    **shard())
    val_loader = Loader(val_ds, min(cfg.eval_batch, len(val_ds)),
                        shuffle=False, **shard())
    val_batch = {k: torch.from_numpy(v).to(device)    # NHWC, as sampled
                 for k, v in next(iter(val_loader)).items()}
    # the metrics are the global batch's, as the JAX CLI's over its
    # process-sharded batch (the normalization takes its min and max)
    val_gt = gather_rows(val_batch["gt"], group)

    def sample_psnrs(refiner, steps, reference_pred):
        """(the prediction, PSNR against `reference_pred`, PSNR against the
        ground truth under the reference's eval convention) of `refiner`
        sampled at `steps`."""
        sampler = build_refiner_sampler_split(
            refiner, cr, vae, RefinerPipelineConfig(
                num_inference_steps=steps, latent_size=latent,
                io_uint8=False, clip_sample=True,
                clip_sample_range=cfg.clip_sample_range), device=device)
        pred = gather_rows(sampler(val_batch["lr"], **sampler_noise(
            sampler, len(val_batch["lr"]),
            seeded_generator(cfg.seed, 10_000, device), group)), group)
        vs_ref = (float(psnr(pred, reference_pred))
                  if reference_pred is not None else float("nan"))
        pred_n = min_max_normalize(pred, per_sample=False)
        gt_n = min_max_normalize(val_gt, per_sample=False)
        return pred, vs_ref, float(psnr_pyiqa(pred_n, gt_n).mean())

    # the distillation target: the exact teacher at its full step count
    exact_pred, _, exact_gt = sample_psnrs(teacher, cfg.teacher_steps, None)
    print(f"[distill] exact teacher @{cfg.teacher_steps} steps: "
          f"gt-PSNR {exact_gt:.2f} dB", flush=True)

    logger = MetricsLogger(cfg.log_dir, "hifi_distill", cfg.name,
                           use_wandb=cfg.use_wandb)
    results = {"teacher_steps": cfg.teacher_steps, "exact_gt_psnr": exact_gt,
               "rounds": []}
    orig_teacher = teacher
    teacher_steps = cfg.teacher_steps
    gstep = 0
    for rnd, student_steps in enumerate(parse_ints(cfg.student_steps)):
        if teacher_steps % student_steps:
            raise ValueError(f"teacher steps {teacher_steps} not divisible "
                             f"by student steps {student_steps}")
        substeps = teacher_steps // student_steps
        # the naive baselines: this round's teacher, and the original
        # weights (plain DDIM step reduction, the reference's only fast
        # option), at the student's step count
        _, naive_vs_exact, naive_gt = sample_psnrs(teacher, student_steps,
                                                   exact_pred)
        _, orig_vs_exact, orig_gt = sample_psnrs(orig_teacher, student_steps,
                                                 exact_pred)

        student = copy.deepcopy(teacher).requires_grad_(True)
        state = TrainState.create(
            student, functools.partial(adamw_cosine, base_lr=cfg.lr,
                                       warmup_steps=cfg.warmup_steps,
                                       total_steps=cfg.steps_per_round,
                                       capturable=cfg.cuda_graphs),
            device=device, group=group)
        step_fn = graphed(cfg, make_distill_train_step(
            cr, vae, num_student_steps=student_steps, substeps=substeps,
            clip_sample=True, clip_sample_range=cfg.clip_sample_range,
            stratified=cfg.stratified, device=device))

        it = iter(loader)
        for i in range(cfg.steps_per_round):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(loader)
                batch = next(it)
            state, m = step_fn(
                state, teacher, to_device({k: batch[k] for k in ("lr", "gt")},
                                          device),
                generator=seeded_generator(cfg.seed, gstep, device))
            if i % 50 == 0:
                logger.log({"round": rnd, "distill_loss": m["loss"]}, gstep)
            gstep += 1

        _, dist_vs_exact, dist_gt = sample_psnrs(student, student_steps,
                                                 exact_pred)
        row = {"round": rnd, "teacher_steps": teacher_steps,
               "student_steps": student_steps, "substeps": substeps,
               "final_loss": float(m["loss"]),
               "naive_vs_exact_psnr": naive_vs_exact,
               "naive_gt_psnr": naive_gt,
               "orig_naive_vs_exact_psnr": orig_vs_exact,
               "orig_naive_gt_psnr": orig_gt,
               "distilled_vs_exact_psnr": dist_vs_exact,
               "distilled_gt_psnr": dist_gt}
        results["rounds"].append(row)
        print(f"[distill] round {rnd}: {teacher_steps}->{student_steps} "
              f"steps (k={substeps}) | naive {student_steps}-step: "
              f"{naive_vs_exact:.2f} dB vs exact ({naive_gt:.2f} gt; "
              f"orig weights {orig_gt:.2f} gt) | "
              f"distilled: {dist_vs_exact:.2f} dB vs exact "
              f"({dist_gt:.2f} gt)", flush=True)
        CheckpointManager(os.path.join(
            cfg.ckpt_dir, cfg.name, f"round{rnd}_s{student_steps}")).save(
                gstep, state)

        teacher = student.eval().requires_grad_(False)
        teacher_steps = student_steps
    logger.close()
    return results


if __name__ == "__main__":
    main()
