"""IDC identity-verification eval CLI (counterpart of
hifidiff_tpu/cli/test_idc.py, the reference's `test_idc.py`).

Per batch: sim_hf = cos(IDC(CR(lr)), IDC(pos or gt)), sim_ck =
cos(IDC(CR(lr)), IDC(other)); the reference counts a BATCH correct iff
mean(sim_hf) > mean(sim_ck) (`test_idc.py:23-39`), returned as
`batch_accuracy`, beside the per-sample accuracy (`sample_accuracy`).

It runs on one device, the card unless `--device cpu`, on the held-out split
of `--synthetic N` or `--procedural N` data, or on `--dataroot` (K-Face:
the IDC triplets of its test split, `data.kface.KFaceIDCDataset` at its
default seed, as the JAX CLI reads them).

    python -m hifidiff_tpu_torch.cli.test_idc --cr-ckpt ... --idc-ckpt ... \
        --procedural 64
"""

from __future__ import annotations

import dataclasses

from hifidiff_tpu_torch.cli.common import (load_weights, parse_config,
                                           parse_ints, require_data, seeded,
                                           smoke_datasets)
from hifidiff_tpu_torch.parallel.mesh import to_device
from hifidiff_tpu_torch.cli.pretrain_idc import KEYS, embeddings, frozen_cr
from hifidiff_tpu_torch.data.core import Loader
from hifidiff_tpu_torch.devices import resolve_device
from hifidiff_tpu_torch.eval.metrics import identity_cosine
from hifidiff_tpu_torch.models.idc import IDCEncoder


@dataclasses.dataclass
class Config:
    dataroot: str = ""          # K-Face (IDC triplets of its test split)
    cr_ckpt: str = ""
    idc_ckpt: str = ""
    batch_size: int = 8
    size: int = 128
    cr_width: int = 32
    cr_enc_depths: str = "2,2,4,8"
    cr_mid_depth: int = 8
    idc_stages: str = "3,4,6,3"
    seed: int = 0
    synthetic: int = 0
    procedural: int = 0
    proc_id_spread: float = 1.0   # <1: hard-identity family
    proc_light_jitter: float = 0.0  # >0: per-sample input lighting nuisance
    proc_detail: float = 0.0    # >0: per-identity facial-mark detail
    proc_clutter: int = 0       # >0: per-sample background shapes
    device: str = "cuda"        # "cpu" only when asked for


def main(argv=None) -> dict:
    cfg = parse_config(Config, argv, "IDC identity verification eval")
    require_data(cfg, ("dataroot",))
    device = resolve_device(cfg.device, "test_idc")
    cr = frozen_cr(cfg, device)
    with seeded(cfg.seed):
        idc = IDCEncoder(stage_sizes=parse_ints(cfg.idc_stages))
    idc = load_weights(idc, cfg.idc_ckpt, "IDC").to(device)

    smoke = smoke_datasets(cfg, KEYS)
    if smoke is not None:
        ds = smoke[1]   # held-out split (never-trained poses)
    else:
        from hifidiff_tpu_torch.data.kface import KFaceIDCDataset

        ds = KFaceIDCDataset(cfg.dataroot, split="test", size=cfg.size)
    loader = Loader(ds, cfg.batch_size, shuffle=False)

    batch_correct, sample_correct, n_samples, n_batches = 0, 0, 0, 0
    for batch in loader:
        a, pos, neg = embeddings(cr, idc, to_device(batch, device))
        sim_hf = identity_cosine(a, pos).cpu().numpy()
        sim_ck = identity_cosine(a, neg).cpu().numpy()
        batch_correct += int(sim_hf.mean() > sim_ck.mean())
        sample_correct += int((sim_hf > sim_ck).sum())
        n_samples += len(sim_hf)
        n_batches += 1
        print(f"({n_batches}/{len(loader)}) CR-HF vs. CR-CK: "
              f"{sim_hf.mean():.4f} {sim_ck.mean():.4f} "
              f"{'OK' if sim_hf.mean() > sim_ck.mean() else 'X'}")

    out = {"batch_accuracy": batch_correct / max(1, n_batches),
           "sample_accuracy": sample_correct / max(1, n_samples)}
    print(f"test accuracy (batch-mean, reference convention): "
          f"{out['batch_accuracy']:.4f}")
    print(f"test accuracy (per-sample): {out['sample_accuracy']:.4f}")
    return out


if __name__ == "__main__":
    main()
