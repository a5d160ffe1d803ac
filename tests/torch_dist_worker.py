"""The ranks of tests/test_torch_parallel.py's process groups, and what they
share with the test: the tiny models and batches of every training stage,
built the same way in every process from seeds.

A child is one rank of a gloo group on the CPU that rendezvouses through a
`file://` store; it imports no jax:

    python tests/torch_dist_worker.py CASE RANK WORLD WORKDIR

It reads what the test wrote into WORKDIR (`setup.pt`, and for the IDC
against JAX `idc_jax.pt`, which it waits for) and writes
WORKDIR/CASE.rank<RANK>.pt.
"""

from __future__ import annotations

import functools
import os
import sys
import time
import zlib

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

RES, LATENT, GLOBAL_B = 32, 8, 4
CR = dict(width=8, resolution=RES, enc_nums=(1, 1), mid_num=1,
          dec_nums=(1, 1))
DEN = dict(width=16, enc_nums=(1, 1), mid_num=1, dec_nums=(1, 1))
REF = dict(latent_size=LATENT, idc_stage_sizes=(1, 1, 1, 1), **DEN)
VAE = dict(block_out=(32, 32, 32), layers_per_block=1)
STAGES = (1, 1, 1, 1)
# the training stages whose N-rank run is held to the 1-rank run
KINDS = ("cr", "idc", "denoiser", "cached", "vae", "refiner", "distill",
         "tiny_dn", "tiny_cr", "tae")
ACCUM, CALLS, LR = 2, 4, 1e-4
IDC_JAX_LR = 5e-4


def _perturbed(module, seed):
    from hifidiff_tpu_torch.random_weights import perturb_

    return perturb_(module, torch.Generator().manual_seed(seed))


def frozen_stack():
    """The frozen CR and VAE of the conditional stages, seeded."""
    from hifidiff_tpu_torch.models.cr import CoarseRestoration
    from hifidiff_tpu_torch.vae.model import AutoencoderKL

    torch.manual_seed(1)
    return (_perturbed(CoarseRestoration(**CR), 1),
            _perturbed(AutoencoderKL(**VAE), 2))


def refiner(seed=3):
    from hifidiff_tpu_torch.models.refiner import FacialRefiner
    from hifidiff_tpu_torch.train.optim import (apply_freeze_mask_,
                                                refiner_freeze_mask)

    torch.manual_seed(seed)
    ref = _perturbed(FacialRefiner(**REF), seed)
    return apply_freeze_mask_(ref, refiner_freeze_mask(ref))


def idc(seed=4):
    from hifidiff_tpu_torch.nn.resnet import ResNet50

    torch.manual_seed(seed)
    return _perturbed(ResNet50(STAGES), seed)


def build(kind):
    """(the module under training, its EMA decay, `call(state, batch,
    draws)`) of a training stage; `draws` is a torch.Generator or a dict of
    the step's draws as tensors."""
    from hifidiff_tpu_torch.models.cr import CoarseRestoration
    from hifidiff_tpu_torch.models.denoiser import Denoiser
    from hifidiff_tpu_torch.models.refiner import FacialRefiner
    from hifidiff_tpu_torch.models.tiny_cr import TinyCR
    from hifidiff_tpu_torch.train import distill, steps
    from hifidiff_tpu_torch.vae.model import AutoencoderKL
    from hifidiff_tpu_torch.vae.tiny import tiny_autoencoder_pair

    cr, vae = frozen_stack()

    def drawn(step, *fixed):
        def call(state, batch, draws):
            if isinstance(draws, dict):
                return step(state, *fixed, batch, **draws)
            return step(state, *fixed, batch, generator=draws)
        return call

    torch.manual_seed(5)
    if kind == "cr":
        step = steps.make_cr_train_step(device="cpu")
        return (_perturbed(CoarseRestoration(**CR), 5), 0.9,
                lambda s, b, d: step(s, b))
    if kind in ("idc", "idc_jax"):
        step = steps.make_idc_train_step(cr, device="cpu")
        return idc(), 0.0, lambda s, b, d: step(s, b)
    if kind == "denoiser":
        step = steps.make_denoiser_train_step(vae, device="cpu")
        return (_perturbed(Denoiser(**DEN), 5), 0.99,
                lambda s, b, d: step(s, b["image"], generator=d))
    if kind == "cached":
        return (_perturbed(Denoiser(**DEN), 5), 0.0,
                drawn(steps.make_denoiser_train_step_cached(device="cpu")))
    if kind == "vae":
        return (_perturbed(AutoencoderKL(**VAE), 5), 0.0,
                drawn(steps.make_vae_train_step(device="cpu")))
    if kind == "refiner":
        return refiner(), 0.9, drawn(steps.make_refiner_train_step(
            cr, vae, device="cpu"))
    if kind == "distill":
        teacher = refiner(6).eval().requires_grad_(False)
        return refiner(6), 0.0, drawn(distill.make_distill_train_step(
            cr, vae, num_student_steps=5, substeps=2, stratified=True,
            device="cpu"), teacher)
    if kind == "tiny_dn":
        teacher = refiner(6).eval().requires_grad_(False)
        student = _perturbed(FacialRefiner(**dict(REF, width=8)), 7)
        student.idc.load_state_dict(teacher.idc.state_dict())
        return student, 0.0, drawn(distill.make_tiny_dn_train_step(
            cr, vae, rollout_steps=2, device="cpu"), teacher)
    if kind == "tiny_cr":
        step = distill.make_tiny_cr_train_step(cr, device="cpu")
        return (TinyCR(width=8, blocks=1, down_factor=2), 0.0,
                lambda s, b, d: step(s, b))
    if kind == "tae":
        pair = torch.nn.ModuleDict(dict(zip(("enc", "dec"),
                                            tiny_autoencoder_pair(4))))
        return pair, 0.0, drawn(distill.make_tae_train_step(vae,
                                                            device="cpu"))
    raise ValueError(kind)


class ConcatShards:
    """One process's view of a `world`-process run's sharded `Loader`s: each
    batch is the processes' batches concatenated, rank 0's rows first (the
    global batch of `train/steps.py`'s docstring). Takes `Loader`'s
    arguments, `batch_size` being the global batch; stands in for a CLI's
    `Loader` in the 1-rank run that the N-rank run is held to."""

    def __init__(self, dataset, batch_size, world=2, shard_index=0,
                 num_shards=1, **kw):
        from hifidiff_tpu_torch.data.core import Loader

        self.parts = [Loader(dataset, batch_size // world, shard_index=r,
                             num_shards=world, **kw) for r in range(world)]

    def __len__(self):
        return len(self.parts[0])

    @property
    def epoch(self):
        return self.parts[0].epoch

    @epoch.setter
    def epoch(self, epoch):
        for part in self.parts:
            part.epoch = epoch

    def __iter__(self):
        for batches in zip(*self.parts):
            yield {k: np.concatenate([b[k] for b in batches])
                   for k in batches[0]}


def global_batch(kind):
    """The IDC's triplet gradient in float32 is far from a float64 run at a
    global batch of 4 (1 - cosine 2e-4, its BatchNorms at 1x1), not at 8
    (3e-7)."""
    return 2 * GLOBAL_B if kind in ("idc", "idc_jax") else GLOBAL_B


def inputs(kind, i):
    """The global batch of call `i` of a stage: NHWC numpy, [0, 1]
    images."""
    rng = np.random.default_rng((zlib.crc32(kind.encode()), i))
    b = global_batch(kind)

    def img(n=b):
        return rng.uniform(0, 1, (n, RES, RES, 3)).astype(np.float32)

    if kind == "cr":
        gt = img()
        patches = np.zeros((b, 4, RES, RES, 3), np.float32)
        for bi in range(b):
            for pi in range(4):
                t0, l0 = rng.integers(0, RES - 8, 2)
                patches[bi, pi, t0:t0 + 8, l0:l0 + 8] = \
                    gt[bi, t0:t0 + 8, l0:l0 + 8]
        return {"lr": img(), "gt": gt, "patches": patches}
    if kind in ("idc", "idc_jax"):
        return {"lr": img(), "pos": img(), "other": img()}
    if kind in ("denoiser", "vae", "tae"):
        return {"image": img()}
    if kind == "cached":
        return {"mean": rng.standard_normal((b, LATENT, LATENT, 4)).astype(
                    np.float32),
                "logvar": rng.uniform(-3, 0, (b, LATENT, LATENT, 4)).astype(
                    np.float32)}
    return {"lr": img(), "gt": img()}


def run(kind, group, calls=CALLS, accum=ACCUM, draws=None, resets=None,
        unsynced_bn=False, make_optim=None):
    """`calls` steps of a stage on this process's rows of each call's global
    batch (all of them without a `group`); draws from `seeded_generator(7,
    i)` (or `draws[i]`, a dict of this process's rows of the draws). After
    each optimizer step: its gradients
    (after the all-reduce), the state dict and the EMA; with `resets` the
    parameters are then set to `resets[k]` (Adam's moments stay)."""
    import torch.distributed as dist

    from hifidiff_tpu_torch.cli.common import seeded_generator
    from hifidiff_tpu_torch.parallel.mesh import to_device
    from hifidiff_tpu_torch.parallel import sync_batch_norm
    from hifidiff_tpu_torch.train.optim import adamw_cosine
    from hifidiff_tpu_torch.train.steps import TrainState

    module, ema, call = build(kind)
    make_optim = make_optim or functools.partial(
        adamw_cosine, base_lr=LR, warmup_steps=0, total_steps=100,
        accumulate_steps=accum)
    state = TrainState.create(module, make_optim, ema_decay=ema,
                              device="cpu", group=group)
    if unsynced_bn:
        sync_batch_norm(module, None)
    seen, applied = {}, state.optimizer.step

    def spy(*a, **k):
        seen.clear()
        seen.update({n: p.grad.clone() for n, p in module.named_parameters()
                     if p.grad is not None})
        return applied(*a, **k)

    state.optimizer.step = spy
    rows = slice(None)
    if group is not None:
        b = global_batch(kind) // dist.get_world_size(group)
        r = dist.get_rank(group)
        rows = slice(r * b, (r + 1) * b)
    losses, record = [], []
    for i in range(calls):
        local = {k: v[rows] for k, v in inputs(kind, i).items()}
        _, m = call(state, to_device(local, "cpu"),
                    seeded_generator(7, i, "cpu") if draws is None
                    else draws[i])
        losses.append(float(m["loss"]))
        if state.mini_step == 0:
            record.append({
                "grads": dict(seen),
                "state": {k: v.clone() for k, v in
                          module.state_dict().items()},
                "ema": None if state.ema_params is None else
                {k: v.clone() for k, v in state.ema_params.items()}})
            if resets is not None:
                module.load_state_dict(resets[len(record) - 1], strict=False)
    return {"losses": losses, "steps": record}


def _rows(draws, rows):
    return [{k: v[rows] for k, v in d.items()} for d in draws]


def case_dp2(rank, world, work):
    """Every stage on 2 ranks and (shared out) on one, the refiner and the IDC
    against JAX's draws and trajectory with their controls, and
    `test_refiner` and `train_refiner` on 2 ranks."""
    import torch.distributed as dist

    from hifidiff_tpu_torch.train import optim, steps

    group = dist.group.WORLD
    b = GLOBAL_B // world
    rows = slice(rank * b, (rank + 1) * b)
    setup = torch.load(os.path.join(work, "setup.pt"), weights_only=False)
    from hifidiff_tpu_torch.parallel import local_batch_to_global

    out = {"ranks": {}, "one": {}, "gathered": local_batch_to_global(
        {"x": np.full((2, 3), rank, np.float32),
         "t": torch.arange(2) + 10 * rank})}
    for kind in KINDS:
        resets = None
        # the 1-rank runs shared out between the ranks
        if kind == "idc" or KINDS.index(kind) % world == rank:
            out["one"][kind] = run(kind, None)
        if kind == "idc":   # Adam's first updates amplify float32 rounding
            resets = [{k: v for k, v in s["state"].items()
                       if not k.endswith("num_batches_tracked")}
                      for s in out["one"][kind]["steps"]]
        out["ranks"][kind] = run(kind, group, resets=resets)
    out["ranks"]["refiner unsynced BN"] = run("refiner", group,
                                              unsynced_bn=True)
    real = steps._rows
    steps._rows = lambda draw, shape, group: draw(tuple(shape))
    try:
        out["ranks"]["refiner local draws"] = run("refiner", group)
    finally:
        steps._rows = real

    refiner_optim = functools.partial(optim.adamw_cosine, warmup_steps=1,
                                      total_steps=100)
    local_draws = _rows(setup["refiner_draws"], rows)
    out["refiner_jax"] = run("refiner", group, 3, 1, local_draws,
                             make_optim=refiner_optim)
    out["refiner_jax unsynced BN"] = run("refiner", group, 3, 1,
                                         local_draws, unsynced_bn=True,
                                         make_optim=refiner_optim)
    out["refiner_jax local draws"] = run(
        "refiner", group, 3, 1, _rows(setup["refiner_draws"], slice(0, b)),
        make_optim=refiner_optim)

    out["unequal rows"] = unequal_rows(group, rank)
    out["bn float64"] = bn_float64(group, rank)

    from hifidiff_tpu_torch.cli import test_refiner, train_refiner
    out["test_refiner"] = test_refiner.main(setup["test_refiner_argv"]
                                            + ["--batch-size", "1"])
    train_refiner.main(setup["train_refiner_argv"] + ["--batch-size", "2"])

    path = os.path.join(work, "idc_jax.pt")
    deadline = time.monotonic() + 100
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError("no JAX IDC trajectory")
        time.sleep(0.05)
    resets = torch.load(path, weights_only=False)
    idc_optim = functools.partial(optim.adam, lr=IDC_JAX_LR)
    out["idc_jax"] = run("idc_jax", group, 3, 1, resets=resets,
                         make_optim=idc_optim)
    return out


def unequal_rows(group, rank):
    """A CR step with rank + 1 rows on each rank: what it raises (None where
    it raised nothing), and whether the parameters stayed as they were."""
    from hifidiff_tpu_torch.parallel.mesh import to_device
    from hifidiff_tpu_torch.train import optim, steps

    module, _, call = build("cr")
    state = steps.TrainState.create(module, optim.adam, device="cpu",
                                    group=group)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    local = {k: v[:rank + 1] for k, v in inputs("cr", 0).items()}
    try:
        call(state, to_device(local, "cpu"), None)
        raised = None
    except ValueError as e:
        raised = str(e)
    kept = all(torch.equal(v, before[k])
               for k, v in module.state_dict().items())
    return {"raised": raised, "kept": kept}


def bn_float64(group, rank):
    """A float64 BatchNorm in training mode on this rank's 2 of 4 rows, its
    statistics over `group`, against one on all 4 rows in this process
    (mean 100, spread 3: where float32 statistics would round): the largest
    differences of this rank's outputs, input gradients (of the sum of the
    outputs times fixed weights over the 4 rows) and running statistics."""
    from hifidiff_tpu_torch.nn.layers import BatchNorm2d
    from hifidiff_tpu_torch.parallel import sync_batch_norm

    g = torch.Generator().manual_seed(11)
    x = torch.randn(4, 3, 5, 5, generator=g, dtype=torch.float64) * 3 + 100
    w = torch.randn(4, 3, 5, 5, generator=g, dtype=torch.float64)
    rows = slice(2 * rank, 2 * rank + 2)
    bns = [BatchNorm2d(3).double() for _ in range(2)]
    sync_batch_norm(bns[0], group)
    xs = [x[rows].clone().requires_grad_(), x.clone().requires_grad_()]
    ys = [bn(t) for bn, t in zip(bns, xs)]
    (ys[0] * w[rows]).sum().backward()
    (ys[1] * w).sum().backward()
    return {"y": float((ys[0] - ys[1][rows]).abs().max()),
            "dx": float((xs[0].grad - xs[1].grad[rows]).abs().max()),
            "stats": max(float((a - b).abs().max()) for a, b in (
                (bns[0].running_mean, bns[1].running_mean),
                (bns[0].running_var, bns[1].running_var)))}


def case_tp4(rank, world, work):
    """The denoiser with its layers of 64 channels or more split over a
    (data 2, model 2) mesh, forward and gradient, against the unsharded
    denoiser on the same rows in the same process; and the control without
    the input gradient's all-reduce."""
    from hifidiff_tpu_torch.parallel import make_mesh, shard_params_tp
    from hifidiff_tpu_torch.parallel import tp

    setup = torch.load(os.path.join(work, "setup.pt"), weights_only=False)
    mesh = make_mesh(4, axes=("data", "model"), shape=(2, 2))
    d = mesh.index["data"]
    rows = slice(2 * d, 2 * d + 2)
    lat = setup["tp_latents"][rows].clone().requires_grad_(True)
    t = setup["tp_t"][rows]
    weight = setup["tp_weight"][rows]

    def forward(model, x):
        out = model(x, t)
        (out * weight).sum().backward()
        return out.detach()

    out = {}
    for label, patch in (("tp", None), ("tp no input all-reduce", True)):
        plain = tp_denoiser(setup)
        sharded = tp_denoiser(setup)
        out[f"{label} swapped"] = shard_params_tp(sharded, mesh,
                                                  min_features=64)
        x1 = lat.detach().clone().requires_grad_(True)
        x2 = lat.detach().clone().requires_grad_(True)
        real = tp._CopyToGroup.backward
        if patch:
            tp._CopyToGroup.backward = staticmethod(lambda ctx, g: (g, None))
        try:
            y2 = forward(sharded, x2)
        finally:
            tp._CopyToGroup.backward = staticmethod(real)
        y1 = forward(plain, x1)
        grads, shards = {}, dict(sharded.named_parameters())
        for n, p1 in plain.named_parameters():
            p2, g1 = shards[n], p1.grad
            if p2.shape != p1.shape:     # this rank's output channels
                k = mesh.index["model"]
                g1 = g1[k * p2.shape[0]:(k + 1) * p2.shape[0]]
            grads[n] = (g1, p2.grad)
        out[label] = {"y": (y1, y2), "dx": (x1.grad, x2.grad),
                      "grads": grads, "data": d}
    return out


def tp_denoiser(setup):
    from hifidiff_tpu_torch.models.denoiser import Denoiser

    den = Denoiser(width=32, enc_nums=(1, 1), mid_num=1, dec_nums=(1, 1))
    den.load_state_dict(setup["tp_state"])
    return den


CASES = {"dp2": case_dp2, "tp4": case_tp4}


def main():
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    from hifidiff_tpu_torch.parallel import maybe_initialize

    maybe_initialize(init_method=f"file://{os.path.join(work, 'store')}",
                     world_size=world, rank=rank, backend="gloo",
                     device="cpu")
    out = CASES[case](rank, world, work)
    torch.save(out, os.path.join(work, f"{case}.rank{rank}.pt"))


if __name__ == "__main__":
    main()
