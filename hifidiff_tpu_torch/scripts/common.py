"""What the quality scripts share: the pieces each of the JAX package's
scripts defines for itself (`scripts/cache_quality.py:88-91, 125-157`), and
the record every script writes.

A record is the JAX script's result dict, with one more key, "run": the
device the script ran on, the card's name and power limit as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` gives them (None on the
CPU), the commit of the checkout (None outside a git checkout), the argv
and the wall seconds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from hifidiff_tpu_torch.devices import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the convergence demo's narrow stack (cli/convergence_demo.py) as the eval
# and training CLIs' size flags
REFINER_FLAGS = ["--width", "32", "--enc-depths", "1,1", "--mid-depth", "1",
                 "--dec-depths", "1,1", "--idc-stages", "1,1,1,1"]
CR_FLAGS = ["--cr-width", "32", "--cr-enc-depths", "1,1",
            "--cr-mid-depth", "1"]


def record_path(name: str) -> str:
    """A record file at the repo root."""
    return os.path.join(REPO, name)


def drift_psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR between two sampler outputs in [0, 1] (data range 1)."""
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def gt_metrics(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """(gt-PSNR, gt-SSIM) of NHWC faces in [0, 1] against the ground truth:
    both min-max normalized over the whole batch, then the batch means of
    pyiqa's PSNR and SSIM (`eval/metrics.py`). SSIM beside PSNR separates
    solver accuracy from blur: a biased sampler drifts toward the posterior
    mean, which PSNR rewards and SSIM does not."""
    from hifidiff_tpu_torch.eval.metrics import (min_max_normalize,
                                                 psnr_pyiqa, ssim_pyiqa)

    pred_n = min_max_normalize(torch.from_numpy(np.asarray(pred, np.float32)),
                               per_sample=False)
    gt_n = min_max_normalize(torch.from_numpy(np.asarray(gt, np.float32)),
                             per_sample=False)
    return (float(psnr_pyiqa(pred_n, gt_n).mean()),
            float(ssim_pyiqa(pred_n, gt_n).mean()))


def val_batch(cfg, batch_size: int,
              keys: Sequence[str] = ("lr", "gt")) -> Dict[str, np.ndarray]:
    """The first `batch_size` items of the procedural (or synthetic) smoke
    data's held-out split, as `test_refiner` reads it, stacked."""
    from hifidiff_tpu_torch.cli.common import smoke_datasets

    smoke = smoke_datasets(cfg, ("lr", "gt", "patches"))
    if smoke is None:
        raise SystemExit("--procedural (or --synthetic) must be > 0")
    val = smoke[1]
    return {k: np.stack([val[i][k] for i in range(batch_size)])
            for k in keys}


def _card(device: torch.device) -> str:
    """The card's name and power limit, one nvidia-smi line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return out[index if index < len(out) else 0].strip()


def _commit() -> Optional[str]:
    try:
        out = subprocess.run(["git", "-C", REPO, "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=30)
    except OSError:
        return None
    return out.stdout.strip() if out.returncode == 0 else None


class Run:
    """A script's run: started before it computes anything (the device is
    resolved here, so that a script raises without a card before it trains
    or writes), finished by writing the record."""

    def __init__(self, device: str, who: str, argv=None):
        self.device = resolve_device(device, who)
        self.card = _card(self.device) if self.device.type == "cuda" \
            else None
        self.argv = list(sys.argv[1:] if argv is None else argv)
        self.commit = _commit()
        self.t0 = time.perf_counter()
        if self.card:
            print(f"[{who}] {self.card}", flush=True)

    def info(self) -> Dict:
        return {"device": str(self.device), "card": self.card,
                "commit": self.commit, "argv": self.argv,
                "wall_s": time.perf_counter() - self.t0}

    def finish(self, result: Dict, out: str) -> Dict:
        """`result` with the run's fields under "run", written to `out`
        and printed as one JSON line."""
        result["run"] = self.info()
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            with open(out, "w") as f:
                json.dump(result, f, indent=1)
        print(json.dumps(result), flush=True)
        return result
