"""Optimizers, the LR schedule and trainability masks (counterpart of
hifidiff_tpu/train/optim.py, which builds them with optax).

  * Adam(lr 5e-4) for the CR and the IDC; AdamW(lr 1e-4, weight decay 0.01)
    with a cosine schedule after a linear warm-up for the denoiser and the
    refiner, HF `get_cosine_schedule_with_warmup`: linear 0 -> 1 over
    `warmup_steps`, then 0.5 * (1 + cos(pi * progress)) down to 0.
    `torch.optim.Adam` / `AdamW` compute optax's `adam` / `adamw` updates
    (bias-corrected moments, eps outside the root, decoupled decay scaled
    by the learning rate).
  * The schedule is read at count 0 for the first update, as optax reads
    it: with a warm-up the first step moves nothing.
  * Gradient accumulation (`optax.MultiSteps`): `Optim.accumulate_steps`
    mini-steps are averaged into one update; `train.steps.TrainState` does
    the counting.
  * The refiner's partial freeze (`refiner_freeze_mask`): the whole IDC and
    the denoiser's intro conv and encoder stages; the down-convs stay
    trainable, as in the reference. A frozen parameter gets
    `requires_grad=False` and is not handed to the optimizer, so it gets no
    update and no weight decay.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, NamedTuple, Optional

import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR


class Optim(NamedTuple):
    optimizer: torch.optim.Optimizer
    scheduler: Optional[LambdaLR] = None
    accumulate_steps: int = 1


def cosine_factor(step: int, warmup_steps: int, total_steps: int) -> float:
    """The schedule's multiplier of the base learning rate at `step`."""
    if step < warmup_steps:
        return step / max(1.0, warmup_steps)
    progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
    return 0.5 * (1.0 + math.cos(math.pi * min(max(progress, 0.0), 1.0)))


def cosine_with_warmup(optimizer: torch.optim.Optimizer, warmup_steps: int,
                       total_steps: int) -> LambdaLR:
    """The schedule as a `LambdaLR` over the optimizer's base rate; call its
    `step()` after each optimizer update."""
    return LambdaLR(optimizer,
                    lambda s: cosine_factor(s, warmup_steps, total_steps))


def adam(params: Iterable[nn.Parameter], lr: float = 5e-4) -> Optim:
    return Optim(torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                  eps=1e-8))


def adamw_cosine(params: Iterable[nn.Parameter], base_lr: float = 1e-4,
                 warmup_steps: int = 500, total_steps: int = 100_000,
                 weight_decay: float = 0.01,
                 accumulate_steps: int = 1) -> Optim:
    opt = torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return Optim(opt, cosine_with_warmup(opt, warmup_steps, total_steps),
                 accumulate_steps)


def refiner_freeze_mask(refiner: nn.Module) -> Dict[str, bool]:
    """{name: trainable}: the reference's freeze set
    (`models/refiner.py:18-30`) over a FacialRefiner's parameter names:
    `idc.`, `denoiser.intro` and
    `denoiser.encoders.` are frozen; `denoiser.downs.` stays trainable
    (torch's `name.startswith("encoders")` does not include it)."""
    frozen = ("idc.", "denoiser.intro.", "denoiser.encoders.")
    return {n: not n.startswith(frozen)
            for n, _ in refiner.named_parameters()}


def apply_freeze_mask_(module: nn.Module, mask: Dict[str, bool]) -> nn.Module:
    """Set `requires_grad` of every parameter from `mask`, in place."""
    for name, p in module.named_parameters():
        p.requires_grad_(mask[name])
    return module


def trainable_parameters(module: nn.Module):
    return [p for p in module.parameters() if p.requires_grad]
