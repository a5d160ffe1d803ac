"""Tiny-CR quality on the trained convergence stack (counterpart of the JAX
package's `scripts/tiny_cr_quality.py`).

Trains the TinyCR student (`models/tiny_cr.py`) against the convergence
demo's trained coarse restoration net (`cli/train_tiny_cr.py` on the same
procedural data), then measures the end-to-end sampler quality
(pyiqa-convention PSNR / SSIM against the ground truth,
`cli/test_refiner.py`) with the tiny CR in the CR's place: alone against
the exact DDIM-50 sampler, and composed with the tiny autoencoder at ten
DPM-Solver++ or DDIM steps. Writes TINY_CR_QUALITY_TORCH.json at the repo
root: the quality bound behind `test_refiner --tiny-cr-ckpt` and `serve
--tiny-cr-ckpt`.

    python -m hifidiff_tpu_torch.scripts.tiny_cr_quality
    python -m hifidiff_tpu_torch.scripts.tiny_cr_quality --device cpu

Needs `runs/convergence/ckpt/*` (`python -m
hifidiff_tpu_torch.cli.convergence_demo`) and, for the composed rows, the
tiny autoencoder of `hifidiff_tpu_torch.scripts.tae_quality`.
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
    epochs: int = 240
    lr: float = 3e-4
    # student arch for the size-32 stack (the 128px serving student uses
    # the models/tiny_cr.py defaults)
    tiny_width: int = 32
    tiny_blocks: int = 2
    tae_ckpt: str = "runs/torch_tae_quality/ckpt/convdemo"  # "" = skip
    # the composed rows
    tiny_cr_ckpt_dir: str = "runs/torch_tiny_cr_quality/ckpt"
    out: str = record_path("TINY_CR_QUALITY_TORCH.json")
    train: bool = True         # False = reuse an existing tiny-CR ckpt
    device: str = "cuda"       # "cpu" only when asked for


def main(argv=None) -> dict:
    cfg = parse_config(Config, argv, "Tiny-CR quality (trained stack)")
    run = Run(cfg.device, "tiny_cr_quality", argv)

    from hifidiff_tpu_torch.cli import test_refiner, train_tiny_cr

    dev = ["--device", cfg.device]
    ck = lambda s: os.path.join(cfg.ckpt_root, s, cfg.name)  # noqa: E731
    tiny_ckpt = os.path.join(cfg.tiny_cr_ckpt_dir, cfg.name)
    common = ["--proc-id-spread", str(cfg.proc_id_spread),
              "--proc-light-jitter", str(cfg.proc_light_jitter),
              "--procedural", str(cfg.procedural), "--size", str(cfg.size),
              "--batch-size", str(cfg.batch_size), "--seed", str(cfg.seed)] \
        + CR_FLAGS
    student = ["--tiny-width", str(cfg.tiny_width),
               "--tiny-blocks", str(cfg.tiny_blocks)]

    if cfg.train:
        # a fresh run: the eval reads the directory's latest step
        shutil.rmtree(tiny_ckpt, ignore_errors=True)
        train_tiny_cr.main(common + student + [
            "--num-epochs", str(cfg.epochs), "--lr", str(cfg.lr),
            "--cr-ckpt", ck("cr"), "--name", cfg.name,
            "--ckpt-dir", cfg.tiny_cr_ckpt_dir,
            "--out-dir", "runs/torch_tiny_cr_quality/img",
            "--log-dir", "runs/torch_tiny_cr_quality/logs",
            "--save-model-epoch", "80"] + dev)

    eval_base = common + [
        "--vae-blocks", cfg.vae_blocks, "--vae-layers", "1"] \
        + REFINER_FLAGS + [
        "--refiner-ckpt", ck("refiner"), "--cr-ckpt", ck("cr"),
        "--vae-ckpt", ck("vae"), "--grid-every", "0",
        "--out-dir", "runs/torch_tiny_cr_quality/eval"]
    tiny = ["--tiny-cr-ckpt", tiny_ckpt,
            "--tiny-cr-width", str(cfg.tiny_width),
            "--tiny-cr-blocks", str(cfg.tiny_blocks)]
    tae = (["--tae-ckpt", cfg.tae_ckpt, "--tae-mode", "both"]
           if cfg.tae_ckpt else None)

    def evaluate(flags):
        return test_refiner.main(eval_base + flags + dev)

    results = {"trained": True, "size": cfg.size, "epochs": cfg.epochs,
               "tiny_width": cfg.tiny_width, "tiny_blocks": cfg.tiny_blocks,
               "modes": {}}
    # isolation: the CR swap alone against the exact DDIM-50 sampler
    row = {"exact": evaluate(["--num-inference-steps", "50"]),
           "tiny_cr": evaluate(tiny + ["--num-inference-steps", "50"])}
    results["modes"]["50"] = row
    print(f"[tiny_cr_quality] ddim@50: exact {row['exact']['psnr']:.2f} dB"
          f" | tiny-cr {row['tiny_cr']['psnr']:.2f}", flush=True)

    # composition with the tiny autoencoder and a few-step sampler
    if tae:
        for sampler, steps in (("dpmpp", 10), ("ddim", 10)):
            flags = ["--sampler", sampler, "--num-inference-steps",
                     str(steps)]
            row = {"tae_both": evaluate(tae + flags),
                   "tae_tiny_cr": evaluate(tae + tiny + flags)}
            results["modes"][f"{sampler}{steps}"] = row
            print(f"[tiny_cr_quality] {sampler}@{steps}: "
                  f"tae {row['tae_both']['psnr']:.2f} dB | "
                  f"tae+tiny-cr {row['tae_tiny_cr']['psnr']:.2f}",
                  flush=True)

    return run.finish(results, cfg.out)


if __name__ == "__main__":
    main()
