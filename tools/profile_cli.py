"""Where a training CLI's wall time goes, on the card, under cProfile.

    python3 tools/profile_cli.py OUT_TXT [CLI ...]

Builds the kernel library, then runs each CLI's `main` (default:
`train_refiner` twice, then `pretrain_denoiser`) at its default widths and
batch on `--procedural` two of its batches for one epoch, with its logs,
checkpoints and images in a temporary directory, each under cProfile. The
first run also pays the process's imports. Writes each run's wall seconds
and its 45 costliest functions by cumulative time and 25 by own time to
OUT_TXT.
"""

from __future__ import annotations

import cProfile
import importlib
import io
import os
import pstats
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

DEFAULT = ("train_refiner", "train_refiner", "pretrain_denoiser")


def argv(cli, tmp, i):
    """Two default batches of procedural faces, one epoch, run i's own
    directories under `tmp`."""
    return ["--procedural", str(2 * cli.Config.batch_size),
            "--num-epochs", "1", "--seed", "0", "--name", "t",
            "--log-dir", os.path.join(tmp, "logs"),
            "--ckpt-dir", os.path.join(tmp, f"ckpt{i}"),
            "--out-dir", os.path.join(tmp, f"img{i}")]


def main() -> int:
    import torch

    from hifidiff_tpu_torch.ops import kernels

    out_path, names = sys.argv[1], sys.argv[2:] or DEFAULT
    t0 = time.perf_counter()
    kernels.library()
    with open(out_path, "w") as out, tempfile.TemporaryDirectory() as tmp:
        print(f"kernel library: {time.perf_counter() - t0:.1f} s", file=out)
        for i, name in enumerate(names):
            cli = importlib.import_module(f"hifidiff_tpu_torch.cli.{name}")
            prof = cProfile.Profile()
            t0 = time.perf_counter()
            prof.enable()
            cli.main(argv(cli, tmp, i))
            torch.cuda.synchronize()
            prof.disable()
            print(f"== {name}: {time.perf_counter() - t0:.1f} s", file=out)
            for key, n in (("cumulative", 45), ("tottime", 25)):
                text = io.StringIO()
                pstats.Stats(prof, stream=text).sort_stats(key) \
                    .print_stats(n)
                print(text.getvalue(), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
