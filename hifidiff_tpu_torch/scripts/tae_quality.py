"""Tiny-autoencoder quality on the trained convergence stack (counterpart of
the JAX package's `scripts/tae_quality.py`).

Trains the TAESD-style tiny autoencoder (`vae/tiny.py`) against the
convergence demo's trained VAE (`cli/train_tae.py` on the same procedural
data), then measures the end-to-end sampler quality (pyiqa-convention
PSNR / SSIM against the ground truth, `cli/test_refiner.py`) with the tiny
decoder, or the tiny encoder and decoder, in the SD-VAE's place, beside the
exact SD-VAE path, at each of `--steps` DDIM step counts and `--dpmpp-steps`
DPM-Solver++ counts. Writes TAE_QUALITY_TORCH.json at the repo root: the
quality bound behind `test_refiner --tae-ckpt` and `serve --tae-ckpt`.

With `--on-policy` (the default) the exact sampler first runs over the
procedural train split at every step count, and its final latents train
the tiny decoder too (`train_tae --extra-latents`): without them the tiny
decoder only sees the VAE's posteriors of real faces.

    python -m hifidiff_tpu_torch.scripts.tae_quality
    python -m hifidiff_tpu_torch.scripts.tae_quality --device cpu

Needs `runs/convergence/ckpt/*` (`python -m
hifidiff_tpu_torch.cli.convergence_demo`).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Dict

import numpy as np
import torch

from hifidiff_tpu_torch.cli.common import parse_config, parse_ints
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
    tae_epochs: int = 120
    tae_lr: float = 3e-4
    steps: str = "50,10,5"     # sampler step counts to evaluate
    dpmpp_steps: str = "10,5"  # DPM-Solver++ step counts (exact AE +
    # tae_both per count)
    tae_ckpt_dir: str = "runs/torch_tae_quality/ckpt"
    out: str = record_path("TAE_QUALITY_TORCH.json")
    train: bool = True         # False = reuse an existing tae ckpt
    vae_blocks: str = "32,32"  # demo VAE widths; len L => factor 2^(L-1)
    # ("32,32,32,32" for the 128px reference-geometry tier)
    on_policy: bool = True     # harvest sampler latents (train split) and
    # add the on-policy decoder term (train_tae --extra-latents)
    device: str = "cuda"       # "cpu" only when asked for


def batch_draws(seed: int, index: int, shape, device
                ) -> Dict[str, torch.Tensor]:
    """Batch `index`'s sampler noise (posterior, then initial latents,
    NHWC `shape`) from its own generator, `seeded_generator(seed, index)`:
    the counterpart of the JAX script's `fold_in(key, index)`."""
    from hifidiff_tpu_torch.cli.common import seeded_generator

    g = seeded_generator(seed, index, device)
    return {"posterior_noise": torch.randn(shape, generator=g,
                                           device=device),
            "latents_noise": torch.randn(shape, generator=g, device=device)}


def dump_sampler_latents(eval_flags, steps_list, out_npz: str) -> None:
    """Run the exact sampler over the procedural train split at every step
    count the record evaluates, and save the final latents divided by the
    SD-VAE scaling (NHWC, as `z` in an `.npz`): the on-policy training set
    of the tiny decoder. Each step count ends at its own distribution of
    latents, so every one is harvested. The eval reads the val split, so
    nothing leaks. `eval_flags` are `test_refiner`'s (the stack, its
    checkpoints, the data and `--device`)."""
    from hifidiff_tpu_torch.cli import test_refiner as tr
    from hifidiff_tpu_torch.cli.common import (load_refiner_stack,
                                               parse_config, smoke_datasets)
    from hifidiff_tpu_torch.data.core import Loader
    from hifidiff_tpu_torch.devices import resolve_device
    from hifidiff_tpu_torch.pipeline import (RefinerPipelineConfig,
                                             build_refiner_sampler_split)
    from hifidiff_tpu_torch.vae.model import SD_VAE_SCALING

    ecfg = parse_config(tr.Config, eval_flags, "latent dump")
    device = resolve_device(ecfg.device, "dump_sampler_latents")
    cr, vae, refiner, latent = load_refiner_stack(ecfg, device)
    train_ds = smoke_datasets(ecfg, ("lr", "gt"))[0]
    zs = []
    for steps in steps_list:
        sampler = build_refiner_sampler_split(
            refiner, cr, vae, RefinerPipelineConfig(
                num_inference_steps=steps, latent_size=latent,
                clip_sample=True, io_uint8=False,
                clip_sample_range=ecfg.clip_sample_range), device=device)
        st = sampler.stages
        for i, batch in enumerate(Loader(train_ds, ecfg.batch_size,
                                         shuffle=False)):
            lr = torch.from_numpy(batch["lr"]).to(device)
            noise = batch_draws(ecfg.seed, i, (len(lr), latent, latent, 4),
                                device)
            with torch.inference_mode():
                final = st["scan"](*st["prep"](
                    lr, noise["posterior_noise"], noise["latents_noise"]))
            zs.append(final.permute(0, 2, 3, 1).float().cpu().numpy()
                      / SD_VAE_SCALING)
    z = np.concatenate(zs, axis=0)
    os.makedirs(os.path.dirname(out_npz), exist_ok=True)
    np.savez(out_npz, z=z)
    print(f"[tae_quality] on-policy latents {z.shape} "
          f"(steps {steps_list}, std {z.std():.2f}) -> {out_npz}",
          flush=True)


def main(argv=None) -> dict:
    cfg = parse_config(Config, argv, "Tiny-AE quality (trained stack)")
    run = Run(cfg.device, "tae_quality", argv)

    from hifidiff_tpu_torch.cli import test_refiner, train_tae

    dev = ["--device", cfg.device]
    ck = lambda s: os.path.join(cfg.ckpt_root, s, cfg.name)  # noqa: E731
    tae_ckpt = os.path.join(cfg.tae_ckpt_dir, cfg.name)
    common = ["--proc-id-spread", str(cfg.proc_id_spread),
              "--proc-light-jitter", str(cfg.proc_light_jitter),
              "--procedural", str(cfg.procedural), "--size", str(cfg.size),
              "--batch-size", str(cfg.batch_size), "--seed", str(cfg.seed),
              "--vae-blocks", cfg.vae_blocks, "--vae-layers", "1"]

    eval_flags = common + REFINER_FLAGS + CR_FLAGS + [
        "--refiner-ckpt", ck("refiner"), "--cr-ckpt", ck("cr"),
        "--vae-ckpt", ck("vae"), "--grid-every", "0",
        "--out-dir", "runs/torch_tae_quality/eval"]

    def evaluate(flags):
        return test_refiner.main(eval_flags + flags + dev)

    if cfg.train:
        # a fresh run: the checkpoint directory's latest step is what the
        # eval reads, so an older run's files must not outlive this one
        shutil.rmtree(tae_ckpt, ignore_errors=True)
        train_flags = common + [
            "--num-epochs", str(cfg.tae_epochs), "--lr", str(cfg.tae_lr),
            "--vae-ckpt", ck("vae"), "--name", cfg.name,
            "--ckpt-dir", cfg.tae_ckpt_dir,
            "--out-dir", "runs/torch_tae_quality/img",
            "--log-dir", "runs/torch_tae_quality/logs",
            "--save-model-epoch", "40"]
        if cfg.on_policy:
            npz = os.path.join("runs", "torch_tae_quality",
                               "sampler_latents.npz")
            dump_sampler_latents(eval_flags + dev,
                                 list(parse_ints(cfg.steps)), npz)
            train_flags += ["--extra-latents", npz]
        train_tae.main(train_flags + dev)

    results = {"trained": True, "size": cfg.size,
               "on_policy": cfg.on_policy, "tae_epochs": cfg.tae_epochs,
               "modes": {}}
    for steps in parse_ints(cfg.steps):
        n = ["--num-inference-steps", str(steps)]
        row = {"exact": evaluate(n),
               "tae_decode": evaluate(n + ["--tae-ckpt", tae_ckpt,
                                           "--tae-mode", "decode"]),
               "tae_both": evaluate(n + ["--tae-ckpt", tae_ckpt,
                                         "--tae-mode", "both"])}
        results["modes"][str(steps)] = row
        print(f"[tae_quality] steps={steps}: "
              f"exact {row['exact']['psnr']:.2f} dB | "
              f"tiny-dec {row['tae_decode']['psnr']:.2f} | "
              f"tiny-both {row['tae_both']['psnr']:.2f}", flush=True)

    results["dpmpp"] = {}
    for steps in parse_ints(cfg.dpmpp_steps):
        flags = ["--sampler", "dpmpp", "--num-inference-steps", str(steps)]
        row = {"exact": evaluate(flags),
               "tae_both": evaluate(flags + ["--tae-ckpt", tae_ckpt,
                                             "--tae-mode", "both"])}
        results["dpmpp"][str(steps)] = row
        print(f"[tae_quality] dpmpp@{steps}: "
              f"exact {row['exact']['psnr']:.2f} dB | "
              f"tiny-both {row['tae_both']['psnr']:.2f}", flush=True)

    return run.finish(results, cfg.out)


if __name__ == "__main__":
    main()
