"""The tiny distilled autoencoder, NCHW (counterpart of
hifidiff_tpu/vae/tiny.py): small constant-width residual conv nets that stand
in for the SD-VAE's encode and decode at the split sampler's seams
(`pipeline.build_refiner_sampler_split(tiny_enc=..., tiny_dec=...)`).

Conventions are the SD-VAE's, so the sampler swaps them in place:
  * `TinyEncoder(x)` takes images in [-1, 1] and returns the UNSCALED latent
    posterior mean (the tiny path is deterministic);
  * `TinyDecoder(z)` takes UNSCALED latents (divide the diffusion-space
    latent by SD_VAE_SCALING first) and returns images in [-1, 1].

The JAX package has no state-dict layout for these modules; the port's names
are its own (`conv_in`, `stages.{i}.{j}.conv1`, `ups.{i}` / `downs.{i}`,
`conv_out`) and `convert.tiny_decoder_state_dict` /
`tiny_encoder_state_dict` map the JAX trees onto them. The modules compute
in the dtype of their parameters.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class TinyResBlock(nn.Module):
    """conv3x3 -> relu -> conv3x3 + skip -> relu, constant width."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x + self.conv2(F.relu(self.conv1(x))))


def _stages(widths: Sequence[int], blocks_per_stage: int) -> nn.ModuleList:
    return nn.ModuleList(
        nn.Sequential(*(TinyResBlock(w) for _ in range(blocks_per_stage)))
        for w in widths)


class TinyDecoder(nn.Module):
    """Unscaled latents (B, 4, h, w) -> images (B, 3, h * 2^(S-1), ...) in
    [-1, 1], S = len(widths); widths[0] at the latents' resolution. Each
    upsample is a 1x1 conv to 4x the next width and PixelShuffle(2)."""

    def __init__(self, widths: Sequence[int] = (128, 64, 64, 64),
                 blocks_per_stage: int = 2, in_channels: int = 4,
                 out_channels: int = 3):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, widths[0], 3, padding=1)
        self.stages = _stages(widths, blocks_per_stage)
        self.ups = nn.ModuleList(nn.Conv2d(w, 4 * w_next, 1, bias=False)
                                 for w, w_next in zip(widths, widths[1:]))
        self.conv_out = nn.Conv2d(widths[-1], out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv_in(z.to(self.conv_in.weight.dtype)))
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i < len(self.ups):
                x = F.pixel_shuffle(self.ups[i](x), 2)
        return self.conv_out(x)


class TinyEncoder(nn.Module):
    """Images (B, 3, H, W) in [-1, 1] -> UNSCALED latent mean
    (B, latent_channels, H / 2^(S-1), ...); widths[0] at the image's
    resolution, each downsample a 3x3 stride-2 conv."""

    def __init__(self, widths: Sequence[int] = (64, 64, 64, 128),
                 blocks_per_stage: int = 2, latent_channels: int = 4,
                 in_channels: int = 3):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, widths[0], 3, padding=1)
        self.stages = _stages(widths, blocks_per_stage)
        self.downs = nn.ModuleList(nn.Conv2d(w, w_next, 3, stride=2,
                                             padding=1)
                                   for w, w_next in zip(widths, widths[1:]))
        self.conv_out = nn.Conv2d(widths[-1], latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv_in(x.to(self.conv_in.weight.dtype)))
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i < len(self.downs):
                x = self.downs[i](x)
        return self.conv_out(x)


def tiny_widths_for(scale_factor: int, wide: int = 128,
                    narrow: int = 64) -> Tuple[int, ...]:
    """Stage widths for a spatial scale factor 2^(S-1): factor 8 (the
    SD-VAE) -> 4 stages, factor 2 -> 2."""
    stages = max(1, scale_factor.bit_length())
    return (wide,) + (narrow,) * (stages - 1)


def tiny_autoencoder_pair(scale_factor: int = 8
                          ) -> Tuple[TinyEncoder, TinyDecoder]:
    """(TinyEncoder, TinyDecoder) sized for `scale_factor` (image / latent
    side)."""
    dec_w = tiny_widths_for(scale_factor)
    return (TinyEncoder(widths=tuple(reversed(dec_w))),
            TinyDecoder(widths=dec_w))
