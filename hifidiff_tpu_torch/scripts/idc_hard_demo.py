"""Stage-2 (IDC) convergence on the hard procedural identity family
(counterpart of the JAX package's `scripts/idc_hard_demo.py`).

On the legacy procedural family a trained CR satisfies the triplet margin
at initialization (loss 0 at the first step, verification accuracy 1.0 by
construction), so the IDC stage of a convergence run proves nothing there.
This script runs the real stage-1 and stage-2 CLIs on the hard family
(`data/procedural.py`: `id_spread` packs the identities toward the family
mean, `light_jitter` adds per-sample input illumination, `detail` paints
per-identity facial marks, `clutter` per-photo background shapes) and
records the evidence the reference's stage 2 exists for
(`pretrain_idc.py:27-28,119`):

  * the triplet train loss starts materially above zero and falls,
  * the val triplet loss falls (no metric-collapse overfit),
  * held-out-pose verification accuracy climbs from the random-init
    baseline instead of starting at 1.0.

`--check` (the default) asserts these. Writes IDC_HARD_TORCH.json at the
repo root.

    python -m hifidiff_tpu_torch.scripts.idc_hard_demo
    python -m hifidiff_tpu_torch.scripts.idc_hard_demo --device cpu
"""

from __future__ import annotations

import dataclasses
import json
import os

from hifidiff_tpu_torch.cli.common import parse_config
from hifidiff_tpu_torch.scripts.common import Run, record_path


@dataclasses.dataclass
class Config:
    out: str = record_path("IDC_HARD_TORCH.json")
    run_dir: str = "runs/torch_idc_hard"
    n: int = 768                # 48 identities (n // 16)
    size: int = 32
    batch_size: int = 16
    epochs_cr: int = 10
    epochs_idc: int = 14
    seed: int = 0
    proc_id_spread: float = 0.6
    proc_light_jitter: float = 0.3
    proc_detail: float = 1.0    # >0: per-identity facial-mark detail
    proc_clutter: int = 4       # >0: per-sample background shapes
    name: str = "idchard"
    device: str = "cuda"        # "cpu" only when asked for
    check: bool = True


def check(i: dict) -> None:
    """The hard family's stage-2 assertions on the record's "idc" entry."""
    assert i["train_loss_first"] > 0.05, "loss vacuously zero at init"
    assert i["train_loss_final"] < i["train_loss_first"] / 2, \
        "triplet loss did not halve"
    assert i["val_loss_final"] < i["val_loss_first"], \
        "val triplet loss did not improve"
    assert (i["sample_accuracy_trained"]
            > i["sample_accuracy_random_init"] + 0.1), \
        "accuracy did not climb over the random-init baseline"
    assert i["sample_accuracy_trained"] > 0.85, "trained accuracy low"
    assert i["val_loss_final"] < 1.0, (
        "held-out triplets not satisfied in distance (val loss >= "
        "margin 1.0): the embedding memorizes the identity pool instead "
        "of generalizing")
    print("IDC HARD-FAMILY CHECKS PASSED", flush=True)


def main(argv=None) -> dict:
    cfg = parse_config(Config, argv, "Hard-family IDC convergence artifact")
    run = Run(cfg.device, "idc_hard_demo", argv)

    from hifidiff_tpu_torch.cli import pretrain_idc, test_idc, train_cr

    dev = ["--device", cfg.device]
    hard = ["--proc-id-spread", str(cfg.proc_id_spread),
            "--proc-light-jitter", str(cfg.proc_light_jitter),
            "--proc-detail", str(cfg.proc_detail),
            "--proc-clutter", str(cfg.proc_clutter)]
    common = ["--procedural", str(cfg.n), "--size", str(cfg.size),
              "--batch-size", str(cfg.batch_size), "--seed", str(cfg.seed),
              "--name", cfg.name, "--log-dir",
              os.path.join(cfg.run_dir, "logs")] + hard
    arch = ["--cr-width", "32", "--cr-enc-depths", "1,1",
            "--cr-mid-depth", "1", "--idc-stages", "1,1,1,1"]
    cr_ck = os.path.join(cfg.run_dir, "ckpt", "cr")
    idc_ck = os.path.join(cfg.run_dir, "ckpt", "idc")

    print("=== stage 1: train_cr (hard family) ===", flush=True)
    train_cr.main(common + [
        "--width", "32", "--enc-depths", "1,1", "--mid-depth", "1",
        "--num-epochs", str(cfg.epochs_cr), "--ckpt-dir", cr_ck,
        "--out-dir", os.path.join(cfg.run_dir, "img"),
        "--dump-every", "0", "--save-epoch", str(cfg.epochs_cr // 2)]
        + dev)

    eval_flags = common[:8] + hard + arch + [
        "--cr-ckpt", os.path.join(cr_ck, cfg.name)]
    print("=== random-init IDC baseline ===", flush=True)
    acc_rand = test_idc.main(eval_flags + dev)

    print("=== stage 2: pretrain_idc (hard family) ===", flush=True)
    pretrain_idc.main(common + arch + [
        "--num-epochs", str(cfg.epochs_idc),
        "--cr-ckpt", os.path.join(cr_ck, cfg.name),
        "--ckpt-dir", idc_ck, "--save-epoch", "5"] + dev)
    acc = test_idc.main(eval_flags +
                        ["--idc-ckpt", os.path.join(idc_ck, cfg.name)] + dev)

    with open(os.path.join(cfg.run_dir, "logs",
                           f"hifi_idc.{cfg.name}.jsonl")) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    tl = [r["train_loss"] for r in rows if "train_loss" in r]
    vl = [r["val_loss"] for r in rows if "val_loss" in r]
    result = {
        "description": (
            "Stage-2 IDC convergence on the hard procedural identity "
            "family, through the port's train_cr, pretrain_idc and "
            "test_idc CLIs: the triplet loss through a trained CR, first "
            "and final, train and val, and the held-out-pose verification "
            "accuracy before (random IDC) and after training. The positive "
            "and negative are different photos (own background scene and "
            "illumination) of tightly packed identities with facial-mark "
            "detail; a val loss below the margin 1.0 means held-out "
            "triplets are satisfied in distance, not just in ranking."),
        "config": {"n": cfg.n, "size": cfg.size,
                   "num_ids": max(8, cfg.n // 16),
                   "id_spread": cfg.proc_id_spread,
                   "light_jitter": cfg.proc_light_jitter,
                   "detail": cfg.proc_detail,
                   "clutter": cfg.proc_clutter,
                   "epochs_cr": cfg.epochs_cr,
                   "epochs_idc": cfg.epochs_idc},
        "idc": {
            "train_loss_first": tl[0], "train_loss_final": tl[-1],
            "val_loss_first": vl[0], "val_loss_final": vl[-1],
            "sample_accuracy_random_init": acc_rand["sample_accuracy"],
            "sample_accuracy_trained": acc["sample_accuracy"],
            "batch_accuracy_trained": acc["batch_accuracy"],
        },
    }
    run.finish(result, cfg.out)
    print(json.dumps(result["idc"]), flush=True)

    if cfg.check:
        check(result["idc"])
    return result


if __name__ == "__main__":
    main()
