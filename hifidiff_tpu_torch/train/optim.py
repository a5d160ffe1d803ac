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
  * A step captured as CUDA graphs (`train.graphs`) needs `capturable=True`
    optimizers, which keep their step counts on the card (torch refuses
    them on the CPU). The cosine schedule's rate is then a device tensor,
    the param groups' "lr", which `CosineRate` writes from the host after
    each update: a graph reads it where it lies. The rates are LambdaLR's,
    `base_lr * cosine_factor(k, ...)` rounded to float32.
  * The refiner's partial freeze (`refiner_freeze_mask`): the whole IDC and
    the denoiser's intro conv and encoder stages; the down-convs stay
    trainable, as in the reference. A frozen parameter gets
    `requires_grad=False` and is not handed to the optimizer, so it gets no
    update and no weight decay.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, NamedTuple, Optional, Union

import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR


class Optim(NamedTuple):
    optimizer: torch.optim.Optimizer
    scheduler: Optional[Union[LambdaLR, "CosineRate"]] = None
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


class CosineRate:
    """`cosine_with_warmup` for a capturable optimizer whose param groups'
    "lr" are float32 device tensors: at construction and at every `step()`
    the host writes `base_lr * cosine_factor(last_epoch, ...)` into them
    (a `fill_` on the card's stream, no host read). Its state dict loads
    into a `LambdaLR` and the other way round (`last_epoch` and the base
    rates are what both keep)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 base_lrs: List[float], warmup_steps: int, total_steps: int):
        self.optimizer = optimizer
        self.warmup_steps, self.total_steps = warmup_steps, total_steps
        self.base_lrs = [float(b) for b in base_lrs]
        self.last_epoch = 0
        self._write()

    def get_last_lr(self) -> List[float]:
        factor = cosine_factor(self.last_epoch, self.warmup_steps,
                               self.total_steps)
        return [base * factor for base in self.base_lrs]

    def _write(self) -> None:
        for group, rate in zip(self.optimizer.param_groups,
                               self.get_last_lr()):
            group["lr"].fill_(rate)

    def step(self) -> None:
        self.last_epoch += 1
        self._write()

    def state_dict(self) -> Dict:
        return {"last_epoch": self.last_epoch, "base_lrs": self.base_lrs,
                "_step_count": self.last_epoch + 1,
                "_last_lr": self.get_last_lr(),
                "lr_lambdas": [None] * len(self.base_lrs)}

    def load_state_dict(self, sd: Dict) -> None:
        self.last_epoch = sd["last_epoch"]
        self.base_lrs = [float(b) for b in sd["base_lrs"]]
        self._write()


def _on_card(params: list, who: str) -> None:
    if any(p.device.type != "cuda" for p in params):
        raise ValueError(f"{who}(capturable=True): a capturable optimizer "
                         "keeps its state on the card, and the parameters "
                         f"are on {params[0].device}")


def adam(params: Iterable[nn.Parameter], lr: float = 5e-4,
         capturable: bool = False) -> Optim:
    """Adam at a constant rate; `capturable` for a step captured as CUDA
    graphs (the parameters on the card)."""
    params = list(params)
    if capturable:
        _on_card(params, "adam")
    return Optim(torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                  eps=1e-8, capturable=capturable))


def adamw_cosine(params: Iterable[nn.Parameter], base_lr: float = 1e-4,
                 warmup_steps: int = 500, total_steps: int = 100_000,
                 weight_decay: float = 0.01,
                 accumulate_steps: int = 1,
                 capturable: bool = False) -> Optim:
    """AdamW on the cosine schedule; `capturable` for a step captured as
    CUDA graphs: the rate a float32 tensor on the parameters' card, written
    by `CosineRate`."""
    params = list(params)
    if not capturable:
        opt = torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=weight_decay)
        return Optim(opt, cosine_with_warmup(opt, warmup_steps, total_steps),
                     accumulate_steps)
    _on_card(params, "adamw_cosine")
    rate = torch.tensor(base_lr, dtype=torch.float32,
                        device=params[0].device)
    opt = torch.optim.AdamW(params, lr=rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, capturable=True)
    opt.param_groups[0]["lr"] = rate     # the tensor itself, not a copy
    return Optim(opt, CosineRate(opt, [base_lr], warmup_steps, total_steps),
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
