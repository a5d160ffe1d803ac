"""Hybrid Cross Attention (HCA), NCHW (counterpart of hifidiff_tpu/nn/hca.py;
reference `models/fpg/hca.py:5-48`). Fuses guidance features `f_g` into
denoiser features `f_d`:

  * channel branch: (global avg-pool + global max-pool of f_g) -> Linear ->
    ReLU -> Linear -> sigmoid -> per-channel weight w_c;
  * spatial branch: 1x1 conv (C -> C/2) -> BatchNorm -> ReLU -> 1x1 conv
    (C/2 -> 1) -> BatchNorm -> sigmoid -> one-channel map w_s;
  * f_o = f_d + w_c * f_d + w_s * f_d, then 3x3 conv + BatchNorm + ReLU.

BatchNorm is `nn.layers.BatchNorm2d` (eps 1e-5): running statistics in eval
mode; in training mode batch statistics, with the running variance updated
as the JAX package updates it. The sampler's hoisted `gates` are for eval
mode; a training forward computes them from `f_g` on batch statistics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from hifidiff_tpu_torch.nn.layers import BatchNorm2d


class HybridCrossAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.channel_mlp = nn.Sequential(nn.Linear(dim, dim), nn.ReLU(),
                                         nn.Linear(dim, dim), nn.Sigmoid())
        self.spatial_mlp = nn.Sequential(
            nn.Conv2d(dim, dim // 2, 1), BatchNorm2d(dim // 2), nn.ReLU(),
            nn.Conv2d(dim // 2, 1, 1), BatchNorm2d(1), nn.Sigmoid())
        self.fused_mlp = nn.Sequential(nn.Conv2d(dim, dim, 3, padding=1),
                                       BatchNorm2d(dim), nn.ReLU())

    def gates(self, f_g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w_c (B, C, 1, 1), w_s (B, 1, H, W)): functions of the guidance
        features alone, so the sampler computes them once before the loop."""
        pooled = f_g.mean(dim=(2, 3)) + f_g.amax(dim=(2, 3))
        w_c = self.channel_mlp(pooled)[:, :, None, None]
        return w_c, self.spatial_mlp(f_g)

    def forward(self, f_g: torch.Tensor, f_d: torch.Tensor,
                gates: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        w_c, w_s = self.gates(f_g) if gates is None else gates
        return self.fused_mlp(f_d + w_c * f_d + w_s * f_d)
