"""Progressive-distillation quality on the trained convergence stack
(counterpart of the JAX package's `scripts/distill_quality.py`).

Runs `cli/distill.py` (progressive distillation, `train/distill.py`) on the
convergence demo's stage files over chained rounds (50 -> 10 -> 5 steps by
default) and records, per round, the distilled few-step student beside the
naive baseline (the teacher's weights run at the student's step count, the
only fast-sampling option the reference has, DDIM step reduction):

  * vs-exact PSNR: the sampler's faces against the exact DDIM-50 teacher's
    (trajectory drift, the column CACHE_QUALITY_TORCH.json reports),
  * gt PSNR: pyiqa-convention PSNR against the ground truth.

Each round's student is saved under `runs/torch_distill_quality/<name>/
round<r>_s<steps>` (what `hifidiff_tpu_torch.scripts.turbo_quality`
reads). Writes DISTILL_QUALITY_TORCH.json at the repo root.

    python -m hifidiff_tpu_torch.scripts.distill_quality
    python -m hifidiff_tpu_torch.scripts.distill_quality --device cpu
"""

from __future__ import annotations

import dataclasses
import os

from hifidiff_tpu_torch.cli.common import parse_config
from hifidiff_tpu_torch.scripts.common import (CR_FLAGS, REFINER_FLAGS, Run,
                                               record_path)


@dataclasses.dataclass
class Config:
    # convergence-demo architecture (cli/convergence_demo.py) + checkpoints
    ckpt_root: str = "runs/convergence/ckpt"
    name: str = "convdemo"
    size: int = 32
    procedural: int = 64
    proc_id_spread: float = 1.0   # match the stack's training family
    proc_light_jitter: float = 0.0  # (hard tier: 0.6 / 0.25)
    proc_detail: float = 0.0    # >0: per-identity facial-mark detail
    proc_clutter: int = 0       # >0: per-sample background shapes
    batch_size: int = 16
    eval_batch: int = 16
    seed: int = 0
    teacher_steps: int = 50
    student_steps: str = "10,5"   # chained rounds (50->10 k=5, 10->5 k=2)
    steps_per_round: int = 2000
    stratified: bool = False   # per-batch even step coverage (variance fix)
    lr: float = 1e-5
    out: str = record_path("DISTILL_QUALITY_TORCH.json")
    device: str = "cuda"          # "cpu" only when asked for


def main(argv=None) -> dict:
    cfg = parse_config(Config, argv, "Distillation quality (trained stack)")
    run = Run(cfg.device, "distill_quality", argv)

    from hifidiff_tpu_torch.cli import distill

    ck = lambda s: os.path.join(cfg.ckpt_root, s, cfg.name)  # noqa: E731
    results = distill.main([
        "--proc-id-spread", str(cfg.proc_id_spread),
        "--proc-light-jitter", str(cfg.proc_light_jitter),
        "--procedural", str(cfg.procedural), "--size", str(cfg.size),
        "--batch-size", str(cfg.batch_size),
        "--eval-batch", str(cfg.eval_batch), "--seed", str(cfg.seed)]
        # the convergence demo's narrow architecture
        + REFINER_FLAGS + CR_FLAGS + [
        "--vae-blocks", "32,32", "--vae-layers", "1",
        "--refiner-ckpt", ck("refiner"), "--cr-ckpt", ck("cr"),
        "--vae-ckpt", ck("vae"),
        "--teacher-steps", str(cfg.teacher_steps),
        "--student-steps", cfg.student_steps,
        "--steps-per-round", str(cfg.steps_per_round),
        "--stratified", str(int(cfg.stratified)),
        "--lr", str(cfg.lr),
        "--ckpt-dir", os.path.join("runs", "torch_distill_quality"),
        "--name", cfg.name, "--device", cfg.device])
    results["trained"] = bool(cfg.ckpt_root)
    results["size"] = cfg.size
    results["steps_per_round"] = cfg.steps_per_round
    results["stratified"] = cfg.stratified
    results["lr"] = cfg.lr
    return run.finish(results, cfg.out)


if __name__ == "__main__":
    main()
