"""Tiny-denoiser quality on the trained convergence stack (counterpart of
the JAX package's `scripts/tiny_dn_quality.py`).

Trains the width-distilled FacialRefiner student (`cli/train_tiny_dn.py`,
`train/distill.make_tiny_dn_train_step`) against the convergence demo's
trained refiner, then measures the end-to-end sampler quality
(pyiqa-convention PSNR / SSIM against the ground truth,
`cli/test_refiner.py`) with the student at the ordinary `--width` /
`--refiner-ckpt` seam: at the exact DDIM-50 configuration, and composed with
the tiny autoencoder (and the tiny CR, where given) at ten DPM-Solver++ or
DDIM steps. Writes TINY_DN_QUALITY_TORCH.json at the repo root.

    python -m hifidiff_tpu_torch.scripts.tiny_dn_quality \
        --tiny-cr-ckpt runs/torch_tiny_cr_quality/ckpt/convdemo
    python -m hifidiff_tpu_torch.scripts.tiny_dn_quality --device cpu

Needs `runs/convergence/ckpt/*` (`python -m
hifidiff_tpu_torch.cli.convergence_demo`); the composed rows also need the
tiny autoencoder of `hifidiff_tpu_torch.scripts.tae_quality` and the tiny
CR of `hifidiff_tpu_torch.scripts.tiny_cr_quality`.
"""

from __future__ import annotations

import dataclasses
import os
import shutil

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
    vae_blocks: str = "32,32"  # demo VAE widths; len L => factor 2^(L-1)
    epochs: int = 160
    lr: float = 3e-4
    rollout_steps: int = 10
    fwd_weight: float = 0.5
    # student arch for the size-32 stack: the teacher is width 32 / enc
    # 1,1 / mid 1, and the student halves the width (4x fewer conv FLOPs)
    tiny_width: int = 16
    tae_ckpt: str = "runs/torch_tae_quality/ckpt/convdemo"  # "" = skip
    # the composed rows
    tiny_cr_ckpt: str = ""                               # "" = skip that row
    tiny_cr_width: int = 32
    tiny_cr_blocks: int = 2
    tiny_dn_ckpt_dir: str = "runs/torch_tiny_dn_quality/ckpt"
    out: str = record_path("TINY_DN_QUALITY_TORCH.json")
    train: bool = True          # False = reuse an existing tiny-DN ckpt
    device: str = "cuda"        # "cpu" only when asked for


def main(argv=None) -> dict:
    cfg = parse_config(Config, argv, "Tiny-DN quality (trained stack)")
    run = Run(cfg.device, "tiny_dn_quality", argv)

    from hifidiff_tpu_torch.cli import test_refiner, train_tiny_dn

    dev = ["--device", cfg.device]
    ck = lambda s: os.path.join(cfg.ckpt_root, s, cfg.name)  # noqa: E731
    tiny_ckpt = os.path.join(cfg.tiny_dn_ckpt_dir, cfg.name)
    data = ["--proc-id-spread", str(cfg.proc_id_spread),
            "--proc-light-jitter", str(cfg.proc_light_jitter),
            "--procedural", str(cfg.procedural), "--size", str(cfg.size),
            "--batch-size", str(cfg.batch_size), "--seed", str(cfg.seed)]
    teacher = REFINER_FLAGS + CR_FLAGS + [
        "--vae-blocks", cfg.vae_blocks, "--vae-layers", "1"]

    if cfg.train:
        # a fresh run: the eval reads the directory's latest step
        shutil.rmtree(tiny_ckpt, ignore_errors=True)
        train_tiny_dn.main(data + teacher + [
            "--tiny-width", str(cfg.tiny_width),
            "--rollout-steps", str(cfg.rollout_steps),
            "--fwd-weight", str(cfg.fwd_weight),
            "--num-epochs", str(cfg.epochs), "--lr", str(cfg.lr),
            "--refiner-ckpt", ck("refiner"), "--cr-ckpt", ck("cr"),
            "--vae-ckpt", ck("vae"), "--name", cfg.name,
            "--ckpt-dir", cfg.tiny_dn_ckpt_dir,
            "--log-dir", "runs/torch_tiny_dn_quality/logs",
            "--save-model-epoch", "40"] + dev)

    eval_base = data + teacher + [
        "--cr-ckpt", ck("cr"), "--vae-ckpt", ck("vae"),
        "--grid-every", "0", "--out-dir", "runs/torch_tiny_dn_quality/eval"]
    exact_r = ["--refiner-ckpt", ck("refiner")]
    tiny_r = ["--refiner-ckpt", tiny_ckpt,
              "--width", str(cfg.tiny_width)]  # overrides teacher's width
    tae = (["--tae-ckpt", cfg.tae_ckpt, "--tae-mode", "both"]
           if cfg.tae_ckpt else None)
    tcr = (["--tiny-cr-ckpt", cfg.tiny_cr_ckpt,
            "--tiny-cr-width", str(cfg.tiny_cr_width),
            "--tiny-cr-blocks", str(cfg.tiny_cr_blocks)]
           if cfg.tiny_cr_ckpt else None)

    def evaluate(flags):
        # --width appears twice where tiny_r is given; argparse keeps the
        # last one, so the student's flags come after the teacher's
        return test_refiner.main(eval_base + flags + dev)

    results = {"trained": True, "size": cfg.size, "epochs": cfg.epochs,
               "tiny_width": cfg.tiny_width,
               "rollout_steps": cfg.rollout_steps, "modes": {}}
    # isolation: the student alone at the exact DDIM-50 configuration
    row = {"exact": evaluate(exact_r + ["--num-inference-steps", "50"]),
           "tiny_dn": evaluate(tiny_r + ["--num-inference-steps", "50"])}
    results["modes"]["50"] = row
    print(f"[tiny_dn_quality] ddim@50: exact {row['exact']['psnr']:.2f} dB"
          f" | tiny-dn {row['tiny_dn']['psnr']:.2f}", flush=True)

    # composition with the tiny autoencoder (and tiny CR) and a few-step
    # sampler
    if tae:
        for sampler, steps in (("dpmpp", 10), ("ddim", 10)):
            flags = ["--sampler", sampler,
                     "--num-inference-steps", str(steps)]
            row = {"tae_both": evaluate(exact_r + tae + flags),
                   "tae_tiny_dn": evaluate(tiny_r + tae + flags)}
            if tcr:
                row["tae_tiny_cr_tiny_dn"] = evaluate(tiny_r + tae + tcr
                                                      + flags)
            results["modes"][f"{sampler}{steps}"] = row
            msg = (f"[tiny_dn_quality] {sampler}@{steps}: "
                   f"tae {row['tae_both']['psnr']:.2f} dB | "
                   f"tae+tiny-dn {row['tae_tiny_dn']['psnr']:.2f}")
            if tcr:
                msg += (" | +tiny-cr "
                        f"{row['tae_tiny_cr_tiny_dn']['psnr']:.2f}")
            print(msg, flush=True)

    return run.finish(results, cfg.out)


if __name__ == "__main__":
    main()
