"""End-to-end training-convergence demo (counterpart of
hifidiff_tpu/cli/convergence_demo.py): every training stage, chained through
the port's real CLIs and their real checkpoint hand-offs, on the
deterministic learnable procedural-face family (`data/procedural.py`).

    python -m hifidiff_tpu_torch.cli.convergence_demo --out-dir runs/conv

runs, in order (reference anchors in parentheses):
  0. `train_vae`          the stage-0 VAE fit (the reference downloads a
                          pretrained SD-2.1 VAE instead,
                          `pretrain_denoiser.py:256-259`)
  1. `train_cr`           (`train_cr.py:56-137`)
  2. `pretrain_idc`       (`pretrain_idc.py:13-78`), frozen stage-1 CR, with
                          `test_idc` before (random IDC) and after
  3. `pretrain_denoiser`  (`pretrain_denoiser.py:123-227`), frozen VAE
  4. `train_refiner`      (`train_refiner.py:128-299`) on the stage-1/2/3
                          checkpoint directories, composed by
                          `compose_refiner`, run in TWO halves with a
                          `--resume` restart in between
  5. `test_refiner` twice: random weights against the trained stack.

Each stage's JSONL metrics (MetricsLogger) are harvested into
`<out_dir>/convergence.json`; `--check` (default) asserts that every stage
learned and that the trained stack beats a random one by at least 1 dB
(`check_summary`, the JAX demo's assertions). Stage argv and order are the
JAX demo's; every stage also gets `--device` (the card unless
`--device cpu`), where the JAX demo switches its backend with `--platform`.
Narrow widths and depths at 32 px, real model families, losses and
samplers.
"""

from __future__ import annotations

import dataclasses
import json
import os

from hifidiff_tpu_torch.cli.common import parse_config


@dataclasses.dataclass
class Config:
    out_dir: str = "runs/convergence"
    log_dir: str = "logs"       # MetricsLogger root used by the stage CLIs
    n: int = 64                 # procedural training samples
    size: int = 32
    batch_size: int = 8
    epochs_vae: int = 80
    epochs_cr: int = 40
    epochs_idc: int = 15
    epochs_dn: int = 60
    epochs_refiner: int = 24
    seed: int = 0
    check: bool = True          # assert convergence criteria
    name: str = "convdemo"
    # hard-identity family: spread < 1 packs identities toward the family
    # mean and light_jitter adds per-sample input illumination, so stage
    # 2's triplet loss starts > 0 and held-out verification accuracy climbs
    # from the random-init baseline instead of being satisfied at init.
    # The defaults keep the legacy family of the JAX package's records.
    proc_id_spread: float = 1.0
    proc_light_jitter: float = 0.0
    # detail-family knobs: proc_detail paints the
    # per-identity facial-mark pattern (fine detail the x4 degradation
    # erases — resolution-scaled, so the family is hard AT the 128px
    # reference geometry, not just at 32px); proc_clutter adds per-sample
    # sharp background shapes shared between lr and gt
    proc_detail: float = 0.0
    proc_clutter: int = 0
    vae_blocks: str = "32,32"   # VAE block widths; len L => factor 2^(L-1).
    # "32,32" (factor 2) keeps the 32px demo at the reference's 16x16
    # latent; "32,32,32,32" (factor 8) at --size 128 reproduces the
    # reference's FULL operating geometry (128px pixels -> 16x16x4 latent,
    # `pretrain_denoiser.py:256-259`, `train_refiner.py:27`)
    vae_layers: int = 1
    device: str = "cuda"        # every stage's --device; "cpu" only when
    # asked for


def _read_jsonl_since(path: str, offset: int):
    if not os.path.exists(path):
        return [], offset
    with open(path) as f:
        f.seek(offset)
        rows = [json.loads(ln) for ln in f if ln.strip()]
        return rows, f.tell()


def _series(rows, field):
    return [r[field] for r in rows if field in r]


def main(argv=None) -> dict:
    cfg = parse_config(Config, argv, "End-to-end convergence demo")
    os.makedirs(cfg.out_dir, exist_ok=True)
    ck = lambda s: os.path.join(cfg.out_dir, "ckpt", s)  # noqa: E731
    out = lambda s: os.path.join(cfg.out_dir, "img", s)  # noqa: E731
    # shared tiny-but-real architecture flags
    latent_flags = ["--vae-blocks", cfg.vae_blocks,
                    "--vae-layers", str(cfg.vae_layers)]
    unet_flags = ["--width", "32", "--enc-depths", "1,1", "--mid-depth", "1"]
    hard_flags = ["--proc-id-spread", str(cfg.proc_id_spread),
                  "--proc-light-jitter", str(cfg.proc_light_jitter),
                  "--proc-detail", str(cfg.proc_detail),
                  "--proc-clutter", str(cfg.proc_clutter)]
    common = ["--procedural", str(cfg.n), "--size", str(cfg.size),
              "--batch-size", str(cfg.batch_size), "--seed", str(cfg.seed),
              "--name", cfg.name, "--log-dir", cfg.log_dir] + hard_flags

    summary = {}
    offsets = {}

    def stage(module, argv):
        """Run a stage CLI's `main` with the JAX demo's argv, on the demo's
        device."""
        return module.main(argv + ["--device", cfg.device])

    def harvest(project):
        path = os.path.join(cfg.log_dir, f"{project}.{cfg.name}.jsonl")
        rows, offsets[project] = _read_jsonl_since(path,
                                                   offsets.get(project, 0))
        return rows

    def prime(project):
        path = os.path.join(cfg.log_dir, f"{project}.{cfg.name}.jsonl")
        offsets[project] = (os.path.getsize(path)
                            if os.path.exists(path) else 0)

    # ---- stage 0: VAE --------------------------------------------------
    from hifidiff_tpu_torch.cli import train_vae

    print("=== stage 0: train_vae ===", flush=True)
    prime("hifi_vae")
    stage(train_vae, common + latent_flags + [
        "--num-epochs", str(cfg.epochs_vae), "--lr", "1e-3",
        "--warmup-steps", "10", "--ckpt-dir", ck("vae"),
        "--out-dir", out("vae"), "--save-model-epoch", "10",
        "--save-image-epoch", "10"])
    rows = harvest("hifi_vae")
    vp = _series(rows, "val_psnr")
    summary["vae"] = {"val_psnr_first": vp[0], "val_psnr_final": vp[-1],
                      "train_loss_first": _series(rows, "train_loss")[0],
                      "train_loss_final": _series(rows, "train_loss")[-1]}
    print(f"[vae] val_psnr {vp[0]:.2f} -> {vp[-1]:.2f} dB", flush=True)

    # ---- stage 1: CR ---------------------------------------------------
    from hifidiff_tpu_torch.cli import train_cr

    print("=== stage 1: train_cr ===", flush=True)
    prime("hifi_cr")
    stage(train_cr, common + unet_flags + [
        "--num-epochs", str(cfg.epochs_cr), "--ckpt-dir", ck("cr"),
        "--out-dir", out("cr"), "--dump-every", "0", "--save-epoch", "10"])
    rows = harvest("hifi_cr")
    tl, vl = _series(rows, "train_loss"), _series(rows, "val_loss")
    summary["cr"] = {"train_loss_first": tl[0], "train_loss_final": tl[-1],
                     "val_loss_first": vl[0], "val_loss_final": vl[-1]}
    print(f"[cr] train {tl[0]:.4f} -> {tl[-1]:.4f}, "
          f"val {vl[0]:.4f} -> {vl[-1]:.4f}", flush=True)

    # ---- stage 2: IDC --------------------------------------------------
    from hifidiff_tpu_torch.cli import pretrain_idc, test_idc

    print("=== stage 2: pretrain_idc ===", flush=True)
    idc_eval_flags = [
        "--procedural", str(cfg.n), "--size", str(cfg.size),
        "--batch-size", str(cfg.batch_size), "--seed", str(cfg.seed),
        "--cr-ckpt", ck("cr/" + cfg.name), "--cr-width", "32",
        "--cr-enc-depths", "1,1", "--cr-mid-depth", "1",
        "--idc-stages", "1,1,1,1"] + hard_flags
    # random-init baseline FIRST: on the hard family (id_spread < 1) the
    # held-out verification accuracy must CLIMB from this to the trained
    # number (an accuracy that is 1.0 at init proves nothing); on the
    # legacy family it documents the same vacuousness
    acc_rand = stage(test_idc, idc_eval_flags)
    prime("hifi_idc")
    stage(pretrain_idc, common + [
        "--num-epochs", str(cfg.epochs_idc), "--cr-ckpt", ck("cr/" + cfg.name),
        "--cr-width", "32", "--cr-enc-depths", "1,1", "--cr-mid-depth", "1",
        "--idc-stages", "1,1,1,1", "--ckpt-dir", ck("idc"),
        "--save-epoch", "5"])
    rows = harvest("hifi_idc")
    tl = _series(rows, "train_loss")
    vl = _series(rows, "val_loss")
    summary["idc"] = {"train_loss_first": tl[0], "train_loss_final": tl[-1],
                      "val_loss_first": vl[0], "val_loss_final": vl[-1]}
    print(f"[idc] train {tl[0]:.4f} -> {tl[-1]:.4f}", flush=True)

    # identity-verification accuracy on held-out poses (the reference's
    # `test_idc.py` end metric)
    acc = stage(test_idc,
                idc_eval_flags + ["--idc-ckpt", ck("idc/" + cfg.name)])
    summary["idc"].update(acc)
    summary["idc"]["sample_accuracy_random_init"] = \
        acc_rand["sample_accuracy"]
    # any non-default hardness knob makes this a hard-family run: the
    # stronger check_summary assertions apply whenever the measured
    # random-init baseline is genuinely below ceiling
    summary["idc"]["hard_family"] = (cfg.proc_id_spread < 1.0
                                     or cfg.proc_light_jitter > 0.0
                                     or cfg.proc_detail > 0.0
                                     or cfg.proc_clutter > 0)
    print(f"[idc] verification accuracy {acc['sample_accuracy']:.3f} "
          f"(random-init baseline {acc_rand['sample_accuracy']:.3f})",
          flush=True)

    # ---- stage 3: denoiser --------------------------------------------
    from hifidiff_tpu_torch.cli import pretrain_denoiser

    print("=== stage 3: pretrain_denoiser ===", flush=True)
    prime("hifi_denoiser")
    stage(pretrain_denoiser, common + latent_flags + unet_flags + [
        "--dec-depths", "1,1", "--num-epochs", str(cfg.epochs_dn),
        "--lr", "5e-4", "--warmup-steps", "20",
        "--vae-ckpt", ck("vae/" + cfg.name),
        "--ckpt-dir", ck("dn"), "--out-dir", out("dn"),
        "--sample-size", "4", "--save-model-epoch", "20",
        "--save-image-epoch", "20"])
    rows = harvest("hifi_denoiser")
    tl = _series(rows, "avg_train_loss")
    summary["denoiser"] = {"train_loss_first": tl[0],
                           "train_loss_final": tl[-1]}
    print(f"[denoiser] avg train {tl[0]:.4f} -> {tl[-1]:.4f}", flush=True)

    # ---- stage 4: refiner (two halves + --resume) ----------------------
    from hifidiff_tpu_torch.cli import train_refiner

    print("=== stage 4: train_refiner (half 1) ===", flush=True)
    prime("hifi_refiner")
    half = max(1, cfg.epochs_refiner // 2)
    ref_flags = common + latent_flags + unet_flags + [
        "--dec-depths", "1,1", "--idc-stages", "1,1,1,1",
        "--cr-width", "32", "--cr-enc-depths", "1,1", "--cr-mid-depth", "1",
        "--lr", "2e-4", "--warmup-steps", "20",
        "--vae-ckpt", ck("vae/" + cfg.name), "--cr-ckpt", ck("cr/" + cfg.name),
        "--idc-ckpt", ck("idc/" + cfg.name),
        "--denoiser-ckpt", ck("dn/" + cfg.name),
        "--ckpt-dir", ck("refiner"), "--out-dir", out("refiner"),
        "--save-epoch", "5"]
    # both halves run with the SAME --num-epochs (same cosine LR schedule
    # an uninterrupted run would see); half 1 checkpoints and stops
    # mid-run, half 2 restores and continues — a faithful kill-and-resume
    stage(train_refiner, ref_flags + [
        "--num-epochs", str(cfg.epochs_refiner),
        "--stop-after-epoch", str(half - 1)])
    print("=== stage 4: train_refiner (resume, half 2) ===", flush=True)
    stage(train_refiner, ref_flags + [
        "--num-epochs", str(cfg.epochs_refiner), "--resume", "1"])
    rows = harvest("hifi_refiner")
    tl, vp = _series(rows, "train_loss"), _series(rows, "val_psnr")
    summary["refiner"] = {"train_loss_first": tl[0],
                          "train_loss_final": tl[-1],
                          "val_psnr_first": vp[0], "val_psnr_final": vp[-1],
                          "resume_epochs": [half, cfg.epochs_refiner]}
    print(f"[refiner] train {tl[0]:.4f} -> {tl[-1]:.4f}, "
          f"val_psnr {vp[0]:.2f} -> {vp[-1]:.2f} dB", flush=True)

    # ---- stage 5: trained stack vs random-init sampler -----------------
    from hifidiff_tpu_torch.cli import test_refiner

    print("=== stage 5: test_refiner random vs trained ===", flush=True)
    eval_flags = ["--procedural", str(cfg.n), "--size", str(cfg.size),
                  "--batch-size", str(cfg.batch_size),
                  "--seed", str(cfg.seed)] + hard_flags + latent_flags + \
        unet_flags + [
        "--dec-depths", "1,1", "--idc-stages", "1,1,1,1",
        "--cr-width", "32", "--cr-enc-depths", "1,1", "--cr-mid-depth", "1",
        "--grid-every", "0"]
    rand = stage(test_refiner,
                 eval_flags + ["--out-dir", out("eval_random")])
    trained = stage(test_refiner, eval_flags + [
        "--refiner-ckpt", ck("refiner/" + cfg.name),
        "--cr-ckpt", ck("cr/" + cfg.name),
        "--vae-ckpt", ck("vae/" + cfg.name),
        "--out-dir", out("eval_trained")])
    summary["eval"] = {"random_init": rand, "trained": trained}
    print(f"[eval] PSNR random {rand['psnr']:.2f} dB vs "
          f"trained {trained['psnr']:.2f} dB", flush=True)

    with open(os.path.join(cfg.out_dir, "convergence.json"), "w") as f:
        json.dump(summary, f, indent=1)

    if cfg.check:
        check_summary(summary)
    return summary


def check_summary(s: dict) -> None:
    """Assert every stage converged materially (used by main and callable
    standalone on a committed convergence.json)."""
    # VAE val is UNSEEN identities (cli/common.py:smoke_datasets) — a
    # real generalization measure. The tiny width-32 VAE plateaus
    # ~20 dB there (vs 27+ on train-identity recon), from ~12 at init.
    # The improvement margin is vs the first LOGGED val (after one full
    # epoch, not true init), so on tiers whose first epoch already does
    # most of the work — e.g. the 128px factor-8 tier, whose 48x
    # compression also lowers the recon ceiling — the >=20 dB absolute
    # bar substitutes (the JAX package's 128px record: 16.8 -> 20.1).
    assert (s["vae"]["val_psnr_final"] > s["vae"]["val_psnr_first"] + 5
            or s["vae"]["val_psnr_final"] > 20), \
        "VAE recon PSNR did not improve materially"
    assert s["vae"]["val_psnr_final"] > 18, "VAE recon PSNR too low"
    assert s["cr"]["train_loss_final"] < s["cr"]["train_loss_first"] / 3, \
        "CR train loss did not drop 3x"
    assert s["cr"]["val_loss_final"] < s["cr"]["val_loss_first"], \
        "CR val loss did not improve (no generalization)"
    # the hard-family assertions only apply when the task IS hard at this
    # scale: hardness is resolution-dependent (the JAX package's records:
    # spread 0.6 / jitter 0.25 gives a 0.77 random-init baseline at 32 px
    # but 1.0 at 64 px — the larger input retains identity geometry a
    # random ResNet already separates). A random baseline of ~1.0 means the instrument
    # cannot discriminate and the legacy checks apply; the vacuousness is
    # visible in the artifact via sample_accuracy_random_init. The
    # committed non-vacuous stage-2 evidence lives in IDC_HARD.json
    # (scripts/idc_hard_demo.py).
    if (s["idc"].get("hard_family")
            and s["idc"].get("sample_accuracy_random_init", 1.0) < 0.98):
        # hard-identity family: the triplet margin must
        # NOT be satisfied at init — the loss starts materially above
        # zero, falls, and held-out verification accuracy climbs from the
        # random-init baseline. This is the non-vacuous stage-2 proof
        # (the reference's stage 2 exists because the task is hard on
        # real faces, `pretrain_idc.py:27-28,119`).
        assert s["idc"]["train_loss_first"] > 0.05, \
            "hard family: IDC triplet loss already ~0 at init (vacuous)"
        assert (s["idc"]["train_loss_final"]
                < s["idc"]["train_loss_first"] / 2), \
            "hard family: IDC triplet loss did not drop 2x"
        assert (s["idc"]["sample_accuracy"]
                > s["idc"]["sample_accuracy_random_init"] + 0.1), \
            "hard family: trained IDC accuracy did not climb over random"
        assert s["idc"]["sample_accuracy"] > 0.85, \
            "hard family: trained IDC accuracy too low"
    else:
        # legacy wide family: triplet loss saturates at exactly 0 once
        # every margin is satisfied; on strong CR stacks (e.g. the n=192
        # scaled run) the FIRST logged step is already 0, so "dropped" OR
        # "saturated at ~0" both count — the end metric is the held-out
        # verification accuracy below.
        assert (s["idc"]["train_loss_final"] < s["idc"]["train_loss_first"]
                or s["idc"]["train_loss_final"] < 1e-3), \
            "IDC triplet loss neither dropped nor saturated at zero"
        assert s["idc"]["sample_accuracy"] > 0.9, \
            "trained IDC does not verify identity on held-out poses"
    assert (s["denoiser"]["train_loss_final"]
            < s["denoiser"]["train_loss_first"]), \
        "denoiser loss did not drop"
    assert (s["refiner"]["train_loss_final"]
            < s["refiner"]["train_loss_first"]), \
        "refiner loss did not drop"
    assert (s["eval"]["trained"]["psnr"]
            > s["eval"]["random_init"]["psnr"] + 1.0), \
        "trained sampler does not beat random init by >=1 dB"
    print("ALL CONVERGENCE CHECKS PASSED", flush=True)


if __name__ == "__main__":
    main()
