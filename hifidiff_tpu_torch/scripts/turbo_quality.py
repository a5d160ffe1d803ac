"""Composed-turbo quality: the distilled few-step student with the tiny
autoencoder (counterpart of the JAX package's `scripts/turbo_quality.py`).

Evaluates the fastest composition of the fast modes on the trained
convergence stack, the progressively distilled refiner
(`hifidiff_tpu_torch.scripts.distill_quality`'s students) with the
on-policy tiny autoencoder (`hifidiff_tpu_torch.scripts.tae_quality`) at
the SD-VAE's seams, beside the exact DDIM-50 teacher and the naive
same-step teacher, through the eval CLI (pyiqa-convention PSNR / SSIM,
`cli/test_refiner.py`). Writes TURBO_QUALITY_TORCH.json at the repo root.

    python -m hifidiff_tpu_torch.scripts.turbo_quality
    python -m hifidiff_tpu_torch.scripts.turbo_quality --device cpu

Needs the earlier runs' checkpoints under `runs/`: the convergence demo's
(`cli/convergence_demo.py`), the distilled students and the tiny
autoencoder.
"""

from __future__ import annotations

import dataclasses
import os

from hifidiff_tpu_torch.cli.common import parse_config
from hifidiff_tpu_torch.scripts.common import (CR_FLAGS, REFINER_FLAGS, Run,
                                               record_path)


@dataclasses.dataclass
class Config:
    ckpt_root: str = "runs/convergence/ckpt"
    name: str = "convdemo"
    size: int = 32
    procedural: int = 64
    proc_id_spread: float = 1.0   # match the stack's training family
    proc_light_jitter: float = 0.0  # (hard tier: 0.6 / 0.25)
    proc_detail: float = 0.0    # >0: per-identity facial-mark detail
    proc_clutter: int = 0       # >0: per-sample background shapes
    batch_size: int = 8
    seed: int = 0
    # (student_steps, ckpt subdir) pairs written by distill_quality
    students: str = "10:round0_s10,5:round1_s5"
    student_root: str = "runs/torch_distill_quality/convdemo"
    tae_ckpt: str = "runs/torch_tae_quality/ckpt/convdemo"
    out: str = record_path("TURBO_QUALITY_TORCH.json")
    device: str = "cuda"          # "cpu" only when asked for


def main(argv=None) -> dict:
    cfg = parse_config(Config, argv, "Composed-turbo quality")
    run = Run(cfg.device, "turbo_quality", argv)

    from hifidiff_tpu_torch.cli import test_refiner

    ck = lambda s: os.path.join(cfg.ckpt_root, s, cfg.name)  # noqa: E731
    base = ["--proc-id-spread", str(cfg.proc_id_spread),
            "--proc-light-jitter", str(cfg.proc_light_jitter),
            "--procedural", str(cfg.procedural), "--size", str(cfg.size),
            "--batch-size", str(cfg.batch_size), "--seed", str(cfg.seed),
            "--vae-blocks", "32,32", "--vae-layers", "1"] \
        + REFINER_FLAGS + CR_FLAGS + [
        "--cr-ckpt", ck("cr"), "--vae-ckpt", ck("vae"), "--grid-every", "0",
        "--out-dir", "runs/torch_turbo_quality/eval"]
    tae = ["--tae-ckpt", cfg.tae_ckpt, "--tae-mode", "both"]
    teacher = ["--refiner-ckpt", ck("refiner")]

    def evaluate(flags):
        return test_refiner.main(base + flags + ["--device", cfg.device])

    results = {"size": cfg.size, "modes": {}}
    results["modes"]["exact50"] = evaluate(
        teacher + ["--num-inference-steps", "50"])
    for pair in cfg.students.split(","):
        steps, sub = pair.split(":")
        student = ["--refiner-ckpt", os.path.join(cfg.student_root, sub)]
        n = ["--num-inference-steps", steps]
        srow = {"naive_teacher": evaluate(teacher + n),
                "distilled": evaluate(student + n),
                "distilled_tae": evaluate(student + tae + n)}
        results["modes"][f"steps{steps}"] = srow
        print(f"[turbo_quality] steps={steps}: "
              f"naive {srow['naive_teacher']['psnr']:.2f} dB | "
              f"distilled {srow['distilled']['psnr']:.2f} | "
              f"distilled+tae {srow['distilled_tae']['psnr']:.2f} "
              f"(exact50 {results['modes']['exact50']['psnr']:.2f})",
              flush=True)

    return run.finish(results, cfg.out)


if __name__ == "__main__":
    main()
