"""Multi-process data-parallel dry run on the CPU (counterpart of
hifidiff_tpu/parallel/mp_dryrun.py).

Real training is one process per card (`torchrun --nproc_per_node N`, the
launch HF Accelerate makes for the reference, `pretrain_denoiser.py:230,
282-287`). This module proves that path without cards: the parent spawns N
processes that rendezvous through a `file://` store on gloo, read disjoint
shards of one seeded `Loader` and run

  * the denoiser train step on 14 samples over 2 processes (batches
    [4, 3]: the ragged final batch included) with the gradients averaged
    over the data group, and the validation metrics on 10 samples (batches
    [4, 1]), each a global-batch value;
  * the DP x TP refiner step of the JAX package's
    `__graft_entry__.dryrun_multichip`: a (data 2, model 2) mesh of 4
    processes, the refiner's layers of 64 channels or more split over the
    model axis (`parallel.tp.shard_params_tp`), BatchNorm and the gradients
    reduced over the data axis.

Each child prints its losses and metrics; the parent asserts that every
child exits 0 within its timeout and that all print the same values.

    python -m hifidiff_tpu_torch.parallel.mp_dryrun [--num-processes 2]
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import tempfile

RES, LATENT = 32, 8
# the directory that holds the package, where the children import it from
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _init(rank: int, world: int, store: str) -> None:
    import torch

    from hifidiff_tpu_torch.parallel import maybe_initialize, process_count

    torch.set_num_threads(1)
    maybe_initialize(init_method=f"file://{store}", world_size=world,
                     rank=rank, backend="gloo", device="cpu")
    assert process_count() == world


def _fmt(values) -> str:
    return " ".join(f"{float(v):.9g}" for v in values)


def child_dp(rank: int) -> None:
    """The denoiser step and the validation metrics over the data axis."""
    from hifidiff_tpu_torch.cli.common import (SyntheticFaceDataset, seeded,
                                               seeded_generator, shard)
    from hifidiff_tpu_torch.data.core import Loader
    from hifidiff_tpu_torch.eval.metrics import reference_eval_metrics
    from hifidiff_tpu_torch.models.denoiser import Denoiser
    from hifidiff_tpu_torch.parallel import (make_mesh, process_count,
                                             shard_batch)
    from hifidiff_tpu_torch.train.optim import adamw_cosine
    from hifidiff_tpu_torch.train.steps import (TrainState,
                                                make_denoiser_train_step)
    from hifidiff_tpu_torch.utils.logging import MetricsLogger
    from hifidiff_tpu_torch.vae.model import AutoencoderKL

    with seeded(0):     # the same seed everywhere: the same init
        denoiser = Denoiser(width=16, enc_nums=(1, 1), mid_num=1,
                            dec_nums=(1, 1))
        vae = AutoencoderKL(block_out=(32, 32, 32), layers_per_block=1)
    mesh = make_mesh()
    state = TrainState.create(
        denoiser, functools.partial(adamw_cosine, warmup_steps=1,
                                    total_steps=4),
        device="cpu", group=mesh.data_group)
    step_fn = make_denoiser_train_step(vae, device="cpu")
    # 14 samples over 2 shards: 7 each, batches [4, 3]
    loader = Loader(SyntheticFaceDataset(14, RES, keys=("image",)), 4,
                    shuffle=True, **shard())
    losses, sizes = [], []
    with tempfile.TemporaryDirectory() as logs:
        logger = MetricsLogger(logs, "mp_dryrun", f"p{rank}")
        for i, batch in enumerate(loader):
            images = shard_batch(batch, "cpu")["image"]
            sizes.append(len(images))
            state, metrics = step_fn(state, images,
                                     generator=seeded_generator(0, i, "cpu"))
            losses.append(float(metrics["loss"]))
            logger.log({"loss": metrics["loss"]}, i)
        logger.close()
    assert sizes == [4, 3] or process_count() != 2, sizes
    assert logger.enabled == (rank == 0)
    print(f"MP_DRYRUN_LOSS r{rank} {_fmt(losses)}", flush=True)

    # validation as the training CLIs run it: a sharded loader, each
    # process's rows, the metrics of the global batch. 10 samples over 2
    # shards: batches [4, 1]
    val = Loader(SyntheticFaceDataset(10, RES, keys=("lr", "gt")), 4,
                 shuffle=False, **shard())
    psnrs = []
    for batch in val:
        lr, gt = (shard_batch({k: batch[k]}, "cpu")[k].permute(0, 2, 3, 1)
                  for k in ("lr", "gt"))
        psnrs.append(float(reference_eval_metrics(lr, gt,
                                                  mesh.data_group)[0]["psnr"]))
    print(f"MP_DRYRUN_VAL r{rank} {_fmt(psnrs)}", flush=True)


def child_dp_tp(rank: int) -> None:
    """The refiner step on a (data 2, model 2) mesh."""
    import torch

    from hifidiff_tpu_torch.cli.common import seeded, seeded_generator
    from hifidiff_tpu_torch.models.cr import CoarseRestoration
    from hifidiff_tpu_torch.models.refiner import FacialRefiner
    from hifidiff_tpu_torch.parallel import make_mesh, shard_params_tp
    from hifidiff_tpu_torch.train.optim import (adamw_cosine,
                                                apply_freeze_mask_,
                                                refiner_freeze_mask)
    from hifidiff_tpu_torch.train.steps import (TrainState,
                                                make_refiner_train_step)
    from hifidiff_tpu_torch.vae.model import AutoencoderKL

    with seeded(0):
        cr = CoarseRestoration(width=8, resolution=RES, enc_nums=(1, 1),
                               mid_num=1, dec_nums=(1, 1))
        vae = AutoencoderKL(block_out=(32, 32, 32), layers_per_block=1)
        refiner = FacialRefiner(latent_size=LATENT, width=16,
                                enc_nums=(1, 1), mid_num=1, dec_nums=(1, 1),
                                idc_stage_sizes=(1, 1, 1, 1))
    mesh = make_mesh(4, axes=("data", "model"), shape=(2, 2))
    apply_freeze_mask_(refiner, refiner_freeze_mask(refiner))
    swapped = shard_params_tp(refiner, mesh, min_features=64)
    assert swapped > 0
    state = TrainState.create(
        refiner, functools.partial(adamw_cosine, warmup_steps=1,
                                   total_steps=10),
        device="cpu", group=mesh.data_group)
    step_fn = make_refiner_train_step(cr, vae, device="cpu")
    g = torch.Generator().manual_seed(0)
    images = torch.rand(2 * 4, 3, RES, RES, generator=g)   # lr, then gt
    d = mesh.index["data"]      # this data row's 2 of the global 4 rows
    batch = {"lr": images[2 * d:2 * d + 2], "gt": images[4 + 2 * d:6 + 2 * d]}
    losses = []
    for i in range(2):
        state, metrics = step_fn(state, batch,
                                 generator=seeded_generator(0, i, "cpu"))
        losses.append(float(metrics["loss"]))
    print(f"MP_DRYRUN_TP r{rank} swapped={swapped} {_fmt(losses)}",
          flush=True)


CHILDREN = {"dp": child_dp, "dp_tp": child_dp_tp}


def spawn(cases, timeout: float = 120.0) -> dict:
    """Run each case ({name: number of processes}) in its own group of
    child processes, all at once, each group rendezvousing through its own
    `file://` store; returns {name: the children's outputs}. Raises if a
    child fails or outlives `timeout` seconds (every child is stopped
    then)."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = {case: [subprocess.Popen(
            [sys.executable, "-m", "hifidiff_tpu_torch.parallel.mp_dryrun",
             "--child", case, "--rank", str(r), "--num-processes",
             str(world), "--store", os.path.join(tmp, case)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT) for r in range(world)]
            for case, world in cases.items()}
        outs = {case: [] for case in cases}
        try:
            for case, group in procs.items():
                for p in group:
                    outs[case].append(p.communicate(timeout=timeout)[0])
        finally:
            for group in procs.values():
                for p in group:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        for case, group in procs.items():
            for p, out in zip(group, outs[case]):
                if p.returncode != 0:
                    raise RuntimeError(f"mp_dryrun child {case} failed "
                                       f"(rc={p.returncode}):\n{out}")
        return outs


def _agreed(outs, tag: str) -> tuple:
    per_rank = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith(tag):
                parts = line.split()
                per_rank[parts[1]] = tuple(parts[2:])
    assert len(per_rank) == len(outs), f"missing {tag} lines: {outs}"
    values = list(per_rank.values())
    assert all(v == values[0] for v in values), \
        f"{tag} differs across processes: {per_rank}"
    return values[0]


def run(num_processes: int = 2, timeout: float = 120.0,
        tp: bool = True) -> dict:
    """Spawn the data-parallel children (and, with `tp`, the 4 DP x TP
    ones), assert that every process printed the same losses and metrics;
    returns them."""
    outs = spawn(dict(dp=num_processes, **({"dp_tp": 4} if tp else {})),
                 timeout)
    got = {"loss": _agreed(outs["dp"], "MP_DRYRUN_LOSS"),
           "val": _agreed(outs["dp"], "MP_DRYRUN_VAL")}
    if tp:
        got["tp"] = _agreed(outs["dp_tp"], "MP_DRYRUN_TP")
    print(f"mp_dryrun OK: {num_processes} processes, train losses and val "
          f"metrics identical: {got}")
    return got


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", choices=sorted(CHILDREN))
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--store", default="")
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    if args.child:
        _init(args.rank, args.num_processes, args.store)
        CHILDREN[args.child](args.rank)
    else:
        run(args.num_processes, args.timeout)


if __name__ == "__main__":
    main()
