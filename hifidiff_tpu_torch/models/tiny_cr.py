"""The tiny distilled Coarse Restoration net, NCHW (counterpart of
hifidiff_tpu/models/tiny_cr.py): one 3x3 stride-`down_factor` conv, residual
blocks at constant width, a 1x1 conv + PixelShuffle back to full resolution
and a 3x3 conv to the delta that is added to the input. It stands in for the
exact CR at the split sampler's CR seam
(`pipeline.build_refiner_sampler_split(tiny_cr=...)`), with the CR's
interface: images (B, 3, H, W) in [0, 1] -> the restored face, unclipped.

State-dict names are the port's own (`down`, `res.{j}.conv1`, `up_proj`,
`conv_out`); `convert.tiny_cr_state_dict` maps the JAX tree onto them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hifidiff_tpu_torch.vae.tiny import TinyResBlock


class TinyCR(nn.Module):
    """H and W must be multiples of `down_factor`."""

    def __init__(self, width: int = 64, blocks: int = 4, down_factor: int = 2,
                 up_width: int = 16, in_channels: int = 3,
                 out_channels: int = 3):
        super().__init__()
        f = self.down_factor = down_factor
        self.down = nn.Conv2d(in_channels, width, 3, stride=f, padding=1)
        self.res = nn.Sequential(*(TinyResBlock(width) for _ in range(blocks)))
        self.up_proj = nn.Conv2d(width, f * f * up_width, 1, bias=False)
        self.conv_out = nn.Conv2d(up_width, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.down.weight.dtype)
        h = self.res(F.relu(self.down(x)))
        h = F.pixel_shuffle(self.up_proj(h), self.down_factor)
        return x + self.conv_out(h)
